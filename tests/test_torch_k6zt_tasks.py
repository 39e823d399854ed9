"""K6zᵀ's task list checked on the CPU: the tasks a plan of occupied rows
carries (``core.tricubic.with_tasks``, one warp's work each: whole short
rows, or one segment of a long row), against the plan's ``offsets``,
``row_seg``, ``seg_row`` and ``z0_range`` and a sequential greedy walk of
its rows; and a numpy walk of the tasks adding into a table, beside the
port's plain version and ``jax.linear_transpose`` of the JAX package's
``zpcubic.interp_rows_with_grad``, on random endpoints and on endpoints
clustered as a bundle's (start points repeated on a few antennas).

The walk sums each task's pairs in plan order by cell, over its rows' z
spans (the kernel's 32-lane scan is not emulated), folds a long row's
segments in order, and adds each cell's sum into the table once.
Tolerances: 1e-5·max|Eᵀ| against table + the plain version and table +
the transpose (f32 sums in another order, as
``test_torch_k5t_accumulate.py``); cells no stencil touches stay bitwise
the table's. A 40 × 36 × 24 grid, each test on its own
``np.random.default_rng``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import zpcubic as jzpc
from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import tricubic as ttri, zpcubic as tzpc

torch.set_num_threads(2)

SHAPE = (40, 36, 24)
ORIGIN = (-400.0, -400.0, 0.0)
SPACING = (20.0, 22.0, 45.0)
LAYOUTS = pytest.mark.parametrize("layout", ["random", "clustered"])


def _grids():
    jg = JGrid.create(ORIGIN, SPACING, SHAPE)
    return jg, convert.grid_from_numpy(jg, device="cpu")


def _points(layout, rng):
    """Endpoints: 701 uniform in and around the grid, or a bundle's: 6
    antennas' start points repeated 40 times each (rows of 40 pairs) and
    240 far endpoints near the top (rows of a few pairs)."""
    lo = np.asarray(ORIGIN)
    hi = lo + np.asarray(SPACING) * (np.asarray(SHAPE) - 1)
    if layout == "random":
        return rng.uniform(lo - 30.0, hi + 30.0, (701, 3)).astype(np.float32)
    ants = np.concatenate([rng.uniform(-120.0, 120.0, (6, 2)),
                           np.zeros((6, 1))], 1)
    far = rng.uniform(lo, hi, (240, 3))
    far[:, 2] = rng.uniform(0.85, 1.0, 240) * hi[2]
    return np.concatenate([np.repeat(ants, 40, 0), far]).astype(np.float32)


def _greedy(plan, nz, task_pairs):
    """The task list by a sequential walk of the plan's rows: the long
    rows' segments first, the rows of most segments first, then the tasks
    of short rows, each kind in walk order."""
    off = plan.offsets.numpy().astype(np.int64)
    cnt = np.diff(off)
    z0 = plan.z0_range.numpy()
    lo = np.maximum(z0[:, 0] - 1, 0)
    hi = np.minimum(z0[:, 1] + 2, nz - 1)
    first_seg = plan.row_seg.numpy()
    short = (cnt > 0) & (cnt <= min(task_pairs, plan.chunk))
    tasks, r = [], 0
    while r < len(cnt):
        if cnt[r] == 0:
            r += 1
        elif not short[r]:
            for j in range(first_seg[r + 1] - first_seg[r]):
                b = off[r] + j * plan.chunk
                tasks.append((r, b, min(b + plan.chunk, off[r + 1]),
                              lo[r] | (hi[r] << 16)))
            r += 1
        else:
            start, pairs, span = r, 0, 0
            while r < len(cnt) and (cnt[r] == 0 or short[r]):
                if short[r]:
                    if (pairs + cnt[r] > task_pairs
                            or span + hi[r] - lo[r] + 1 > nz):
                        break
                    pairs, span = pairs + cnt[r], span + hi[r] - lo[r] + 1
                r += 1
            tasks.append((-1, off[start], off[r], 0))
    n_seg = np.diff(first_seg)
    return sorted(tasks, key=lambda t: 0 if t[0] < 0 else -n_seg[t[0]])


@LAYOUTS
@pytest.mark.parametrize("chunk,task_pairs", [(ttri.SEGMENT_PAIRS, 32),
                                              (7, 32), (1, 5),
                                              (ttri.SEGMENT_PAIRS, 0)])
def test_task_list_is_the_plans_rows_walked_greedily(layout, chunk,
                                                     task_pairs):
    """The tasks cover every live pair once: a task of short rows holds
    whole rows of one segment each, at most ``task_pairs`` pairs, spans
    summing to at most nz; a long row's segments are its tasks, bounds
    from ``offsets``/``row_seg`` and the z span from ``z0_range``; every
    used segment's row (``seg_row``) is in a task; the list is a
    sequential greedy walk's, long rows first; the unused tail is empty
    tasks."""
    rng = np.random.default_rng(71)
    _, tg = _grids()
    pts = torch.from_numpy(_points(layout, rng))
    plan = tzpc.endpoint_plan(tg, pts, chunk=chunk, task_pairs=task_pairs)
    n_tasks = int(plan.n_tasks)
    tasks = plan.tasks[:n_tasks].numpy()
    assert plan.tasks.shape == (plan.n_seg_max, 4)
    assert plan.tasks.dtype == torch.int32
    assert torch.equal(plan.task_counters, torch.zeros(2, dtype=torch.int32))
    assert (plan.tasks[n_tasks:] == torch.tensor([-1, 0, 0, 0])).all()
    assert [tuple(t) for t in tasks] == _greedy(plan, SHAPE[2], task_pairs)
    # the pairs' ranges tile [0, P)
    ranges = tasks[np.argsort(tasks[:, 1], kind="stable"), 1:3]
    assert ranges[0, 0] == 0 and ranges[-1, 1] == int(plan.offsets[-1])
    assert (ranges[1:, 0] == ranges[:-1, 1]).all()
    long_rows = tasks[:, 0] >= 0
    assert not (long_rows[1:] & ~long_rows[:-1]).any()   # long ones first
    off = plan.offsets.numpy()
    counts = np.diff(off)
    seg_of_row = np.diff(plan.row_seg.numpy())
    used_rows = set(plan.seg_row[:int(plan.row_seg[-1])].tolist())
    seen = set()
    for row, beg, end, span in tasks:
        if row < 0:
            assert end - beg <= max(task_pairs, 0)
            rows = np.nonzero((off[:-1] >= beg) & (off[1:] <= end)
                              & (counts > 0))[0]
            assert counts[rows].sum() == end - beg
            assert (seg_of_row[rows] == 1).all()
            z0 = plan.z0_range.numpy()[rows]
            spans = (np.minimum(z0[:, 1] + 2, SHAPE[2] - 1)
                     - np.maximum(z0[:, 0] - 1, 0) + 1)
            assert spans.sum() <= SHAPE[2]
            seen.update(rows.tolist())
        else:
            assert off[row] <= beg < end <= off[row + 1]
            assert end - beg <= plan.chunk
            assert (beg - off[row]) % plan.chunk == 0
            lo, hi = span & 0xFFFF, span >> 16
            z0 = plan.z0_range[row].tolist()
            assert (lo, hi) == (max(z0[0] - 1, 0),
                                min(z0[1] + 2, SHAPE[2] - 1))
            seen.add(int(row))
    assert seen == used_rows
    if task_pairs == 0:
        assert n_tasks == int(plan.row_seg[-1])


def _walk_tasks(plan, table, flat, contrib, nz):
    """table + the transpose by the task list: each task's pairs in plan
    order summed by cell in f32 (a long row's segments into their own
    partial rows, then folded in segment order), each cell's sum added
    once."""
    out = table.copy().reshape(-1)
    order = plan.order.numpy()
    live = plan.live
    pair_terms = {}
    for pid in order:
        n, t = divmod(int(pid), plan.stride)
        k = n * live + t
        pair_terms[int(pid)] = (flat[4 * k:4 * k + 4],
                                contrib[4 * k:4 * k + 4])
    partial = {}
    for row, beg, end, span in plan.tasks[:int(plan.n_tasks)].numpy():
        acc = {}
        for j in range(beg, end):
            for f, c in zip(*pair_terms[int(order[j])]):
                acc[int(f)] = np.float32(acc.get(int(f), np.float32(0))
                                         + np.float32(c))
        if row < 0 or int(plan.row_seg[row + 1] - plan.row_seg[row]) == 1:
            for f, v in acc.items():
                out[f] = np.float32(out[f] + v)
        else:
            partial.setdefault(int(row), []).append(acc)
    for parts in partial.values():
        cells = sorted(set().union(*parts))
        for f in cells:
            v = np.float32(0)
            for p in parts:
                v = np.float32(v + p.get(f, np.float32(0)))
            out[f] = np.float32(out[f] + v)
    return out.reshape(table.shape)


@LAYOUTS
@pytest.mark.parametrize("chunk", [ttri.SEGMENT_PAIRS, 7])
def test_walk_of_the_tasks_is_the_transpose(layout, chunk):
    """A walk of the task list adding into a table, and
    ``interp_rows_with_grad_transpose_add_`` on the CPU, against table +
    ``jax.linear_transpose`` of the reference's ``interp_rows_with_grad``
    and table + the port's plain version (1e-5·max|Eᵀ|); cells no stencil
    touches bitwise the table's."""
    rng = np.random.default_rng(72)
    jg, tg = _grids()
    pts = _points(layout, rng)
    n = pts.shape[0]
    cv = rng.normal(size=(n,)).astype(np.float32)
    cg = rng.normal(size=(n, 3)).astype(np.float32)
    n_rows, nz = SHAPE[0] * SHAPE[1], SHAPE[2]
    table = rng.normal(size=(n_rows, nz)).astype(np.float32)
    tpts, tcv, tcg = (torch.from_numpy(a) for a in (pts, cv, cg))
    plan = tzpc.endpoint_plan(tg, tpts, chunk=chunk)
    # the live (point, translate) pairs' 4 contributions, pair n*7 + t
    flat, contrib = tzpc.value_grad_transpose_terms(tg, tpts, tcv, tcg)
    walked = _walk_tasks(plan, table, flat.numpy(), contrib.numpy(), nz)
    transpose = jax.linear_transpose(
        lambda t: jzpc.interp_rows_with_grad(t, jg, jnp.asarray(pts)),
        jnp.zeros((n_rows, nz), jnp.float32))
    (et,) = transpose((jnp.asarray(cv), jnp.asarray(cg)))
    et = np.asarray(et)
    plain = tzpc.interp_rows_with_grad_transpose_ref(tg, tpts, tcv,
                                                     tcg).numpy()
    added = tzpc.interp_rows_with_grad_transpose_add_(
        torch.from_numpy(table.copy()), tg, tpts, tcv, tcg, plan).numpy()
    tol = 1e-5 * np.abs(et).max()
    for got in (walked, added):
        np.testing.assert_allclose(got, table + et, rtol=0, atol=tol)
        np.testing.assert_allclose(got, table + plain, rtol=0, atol=tol)
    touched = np.zeros(n_rows * nz, bool)
    touched[flat.numpy()] = True
    touched = touched.reshape(n_rows, nz)
    assert np.array_equal(walked[~touched], table[~touched])
    assert np.array_equal(added[~touched], table[~touched])
