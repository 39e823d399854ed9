"""The segmented row plans that kernels K3 and K1eᵀ reduce over, checked
on the CPU: which pairs a plan holds and in what order, a numpy emulation
of the kernels' two-level summation (pairs within a segment, then the
segments of a row in order) against the plain versions and the JAX
package, and the port's default device (the card unless asked for the
CPU).

Tolerances: the emulation against the plain versions and JAX 1e-5·max
(f32 sums in another order; the same bound as the transposes in
``test_torch_adjoint.py``).
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import tricubic as jtri
from ionotomo_tpu_torch import convert
from ionotomo_tpu_torch.core import boxspline as tbox, tricubic as ttri
from ionotomo_tpu_torch.core import grids as tgrids
from ionotomo_tpu_torch.geometry import fermat as tfermat, rays as trays
from ionotomo_tpu_torch.models import chapman as tchapman
from ionotomo_tpu_torch.probes import gather as tgather
from ionotomo_tpu_torch.testing import edge_case_points

torch.set_num_threads(2)

C = 4                     # a small chunk, so rows span several segments


def _counts_case():
    """One pair per point (K = 1) with rows holding 0, C, C+1, 2C and 1
    pairs, the rest empty, and pairs below and above the table."""
    rng = np.random.default_rng(0)
    rows = np.repeat([1, 2, 3, 4, -1, 9], [C, C + 1, 2 * C, 1, 2, 3])
    rng.shuffle(rows)
    ri = rows.astype(np.int32)[:, None]
    z0 = rng.integers(0, 5, rows.size).astype(np.int32)
    return ri, z0, 9, None


def _live_case():
    """K = 3 translates of which the first 2 are live; the third always
    hits row 5, which must then stay empty."""
    rng = np.random.default_rng(1)
    ri = rng.integers(0, 5, (40, 3)).astype(np.int32)
    ri[:, 2] = 5
    return ri, rng.integers(-2, 6, 40).astype(np.int32), 6, 2


def _one_row_case():
    """Every pair on one row: the skew of points clamped onto a corner."""
    rng = np.random.default_rng(2)
    ri = np.zeros((37, 8), np.int32)
    return ri, rng.integers(0, 9, 37).astype(np.int32), 4, 7


def _corner_points_case():
    """zp endpoints far outside one corner of the grid, every one clamped
    to the same base (``testing.edge_case_points`` moved out of the grid):
    their 7 live rows are the same few corner rows."""
    tg = tgrids.Grid3D.create((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (6, 5, 7),
                              device="cpu")
    pts = edge_case_points((6, 5, 7), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 64,
                           np.random.default_rng(3))
    pts[:, :2] = -50.0 - np.abs(pts[:, :2])
    tp = torch.from_numpy(pts)
    bx, by, bz, u, v, _ = tbox._neighborhood(tg, tp)
    dx, dy, _ = tbox._xy_weights(u, v, with_grad=False)
    ri = tbox._row_index(bx, by, dx, dy, tg).numpy()
    return ri, (bz - 1).numpy(), 30, 7


CASES = {"counts": _counts_case, "live": _live_case, "one_row": _one_row_case,
         "corner_points": _corner_points_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_segmented_plan_covers_every_live_pair_once(case):
    ri, z0, n_rows, live = CASES[case]()
    n, stride = ri.shape
    live = stride if live is None else live
    plan = ttri.build_row_plan(torch.from_numpy(ri), n_rows,
                               torch.from_numpy(z0), live=live, chunk=C)
    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    row_seg, seg_row = plan.row_seg.numpy(), plan.seg_row.numpy()
    assert {t.dtype for t in (plan.order, plan.offsets, plan.row_seg,
                              plan.seg_row, plan.counters)} == {torch.int32}
    assert (plan.stride, plan.live, plan.chunk) == (stride, live, C)
    assert plan.stream is None          # a CPU plan belongs to no stream
    # every live pair inside the table exactly once, grouped by row
    ids = (np.arange(n)[:, None] * stride + np.arange(live)).ravel()
    rows = ri[:, :live].ravel()
    inside = ids[(rows >= 0) & (rows < n_rows)]
    held = order[offsets[0]:offsets[-1]]
    np.testing.assert_array_equal(np.sort(held), np.sort(inside))
    assert order.shape == (n * live,)
    for r in range(n_rows):
        group = order[offsets[r]:offsets[r + 1]]
        np.testing.assert_array_equal(ri.ravel()[group], r)
        # by z within the row, by id within a z
        key = z0[group // stride].astype(np.int64) * (n * stride) + group
        assert np.all(np.diff(key) > 0)
        # segments: at least one, each of at most C pairs, covering the row
        n_seg = row_seg[r + 1] - row_seg[r]
        assert n_seg == max(1, -(-len(group) // C))
        np.testing.assert_array_equal(seg_row[row_seg[r]:row_seg[r + 1]], r)
        sizes = [min(C, len(group) - j * C) for j in range(n_seg)]
        assert sum(sizes) == len(group) and max(sizes) <= C
    # the static bound, and the unused segments past the last one
    assert plan.n_seg_max == -(-n * live // C) + n_rows >= row_seg[-1]
    np.testing.assert_array_equal(seg_row[row_seg[-1]:], n_rows)
    assert not plan.counters.any()


def _reduce_by_segments(plan, contributions, nz):
    """What K3 and K1eᵀ compute from a plan, in their order: each segment
    sums its pairs' contributions in plan order into a partial row (f32),
    and each row sums its segments' partials in segment order (the
    kernels' 32-lane scan inside a batch is not emulated).
    ``contributions(p)`` gives the (z, value) list of flat pair p."""
    order, offsets = plan.order.numpy(), plan.offsets.numpy()
    row_seg = plan.row_seg.numpy()
    out = np.zeros((plan.n_rows, nz), np.float32)
    for r in range(plan.n_rows):
        for j in range(row_seg[r + 1] - row_seg[r]):
            beg = offsets[r] + j * plan.chunk
            part = np.zeros(nz, np.float32)
            for p in order[beg:min(beg + plan.chunk, offsets[r + 1])]:
                for z, c in contributions(int(p)):
                    if 0 <= z < nz:
                        part[z] += np.float32(c)
            out[r] += part
    return out


def _rows_inputs(k, l, n=300, rows=40, nz=12, seed=0):
    rng = np.random.default_rng(seed)
    ri = rng.integers(0, rows, (n, k)).astype(np.int32)
    ri[:, k - 1] = ri[:, 0]                  # a row repeated within a point
    ri[:5, 1] = rows + 3                     # outside the table: dropped
    wxy = rng.normal(size=(n, k)).astype(np.float32)
    zi = (rng.integers(-1, nz - l + 2, (n, 1)) + np.arange(l)).astype(np.int32)
    wz = rng.normal(size=(n, l)).astype(np.float32)
    ct = rng.normal(size=(n,)).astype(np.float32)
    table = rng.normal(size=(rows, nz)).astype(np.float32)
    return table, ri, wxy, zi, wz, ct


def _k3_contributions(ct, wxy, zi, wz, stride):
    def contributions(p):
        n, k = divmod(p, stride)
        a = ct[n] * wxy[n, k]
        return [(zi[n, l], a * wz[n, l]) for l in range(zi.shape[1])]
    return contributions


@pytest.mark.parametrize("k,l,xy_first", [(8, 3, True), (16, 4, False)],
                         ids=["zp", "cubic"])
def test_two_level_order_matches_the_plain_version_and_jax(k, l, xy_first):
    """z taps partly outside [0, nz) included: they are dropped."""
    table, ri, wxy, zi, wz, ct = _rows_inputs(k, l)
    plan = ttri.build_row_plan(torch.from_numpy(ri), table.shape[0],
                               torch.from_numpy(zi[:, 0]), chunk=C)
    assert int((plan.row_seg[1:] - plan.row_seg[:-1]).max()) > 1
    got = _reduce_by_segments(plan, _k3_contributions(ct, wxy, zi, wz, k),
                              table.shape[1])
    plain = ttri.rows_value_transpose_ref(
        *map(torch.from_numpy, (ct, ri, wxy, zi, wz)), table.shape).numpy()
    _, vjp = jax.vjp(lambda t: jtri.rows_value(
        t, jnp.asarray(ri), jnp.asarray(wxy), jnp.asarray(zi),
        jnp.asarray(wz), xy_first=xy_first), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    for ref in (plain, want):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("chunk", [4, 1 << 20], ids=["segments", "whole"])
def test_plan_without_the_zero_translate_gives_the_same_sum(chunk):
    """K3 at the zp shape: the 8th translate's weight is 0, so leaving it
    out of the plan (live=7) drops only ±0 terms. With one segment per
    row the sums are bitwise equal; with short segments the segment
    boundaries move with the pair count, so the sums regroup (1e-6·max)."""
    tg = tgrids.Grid3D.create((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (6, 5, 9),
                              device="cpu")
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(edge_case_points(tg.shape, (0.0, 0.0, 0.0),
                                            (1.0, 1.0, 1.0), 200, rng))
    bx, by, bz, u, v, w = tbox._neighborhood(tg, pts)
    dx, dy, wxy = tbox._xy_weights(u, v, with_grad=False)
    ri = tbox._row_index(bx, by, dx, dy, tg)
    zi = bz[:, None] + torch.arange(-1, 2, dtype=torch.int32)[None, :]
    wz = tbox._qb_weights(w)
    assert not wxy[:, 7].any()
    ct = rng.normal(size=(pts.shape[0],)).astype(np.float32)
    contributions = _k3_contributions(ct, wxy.numpy(), zi.numpy(),
                                      wz.numpy(), 8)
    sums = [_reduce_by_segments(
        ttri.build_row_plan(ri, 30, zi[:, 0], live=live, chunk=chunk),
        contributions, 9) for live in (8, tbox.ZP_LIVE_TRANSLATES)]
    if chunk > 1000:
        np.testing.assert_array_equal(sums[1], sums[0])
    else:
        np.testing.assert_allclose(sums[1], sums[0], rtol=0,
                                   atol=1e-6 * np.abs(sums[0]).max())


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _constructors(tmp_path):
    """Each entry through which state enters the port, called with no
    device."""
    cov = types.SimpleNamespace(spectrum=np.ones((4, 4, 3), np.float32),
                                shape=(4, 4, 4), sigma=0.3,
                                length_scale=50.0, kind="sqexp")
    path = tmp_path / "field.h5"
    tgrids.save_field(path, tgrids.Grid3D.create(
        (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (3, 3, 3), device="cpu"),
        np.zeros((3, 3, 3), np.float32))
    a = np.zeros((2, 3), np.float32)
    return {
        "Grid3D.create": lambda: tgrids.Grid3D.create((0, 0, 0), (1, 1, 1),
                                                      (4, 4, 4)),
        "Grid3D.from_bounds": lambda: tgrids.Grid3D.from_bounds(
            (0, 0, 0), (1, 1, 1), (4, 4, 4)),
        "load_field": lambda: tgrids.load_field(path),
        "grid_from_numpy": lambda: convert.grid_from_numpy(
            (0, 0, 0), (1, 1, 1), (4, 4, 4)),
        "field_from_numpy": lambda: convert.field_from_numpy(
            np.zeros((4, 4, 4))),
        "gp_covariance_from_numpy": lambda: convert.gp_covariance_from_numpy(
            cov),
        "grid_enclosing_rays": lambda: tchapman.grid_enclosing_rays(
            np.zeros((2, 3)), np.array([[0.0, 0.0, 1.0]])),
        "probe_inputs": lambda: tgather.probe_inputs(8, 128),
        "make_ray_batch": lambda: trays.make_ray_batch(a, a),
        "sample_straight_rays": lambda: trays.sample_straight_rays(a, a),
    }


CONSTRUCTORS = ["Grid3D.create", "Grid3D.from_bounds", "load_field",
                "grid_from_numpy", "field_from_numpy",
                "gp_covariance_from_numpy", "grid_enclosing_rays",
                "probe_inputs", "make_ray_batch", "sample_straight_rays"]


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructor_without_a_device_needs_the_card(name, monkeypatch,
                                                     tmp_path):
    """No device named and no CUDA: it raises, it does not hand back CPU
    tensors; naming the CPU works."""
    call = _constructors(tmp_path)[name]
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_numpy_inputs_meet_the_device_of_their_state(monkeypatch):
    """Without a card: numpy rays traced through a CPU grid land on the
    CPU; a CPU tensor keeps its device beside numpy; constructors take
    device='cpu'."""
    _no_card(monkeypatch)
    grid = tgrids.Grid3D.from_bounds((-400, -400, 0.0), (400, 400, 1100.0),
                                     (8, 8, 8), device="cpu")
    m = tchapman.log_parametrize(tchapman.chapman_field(grid))
    o = np.zeros((3, 3), np.float32)
    d = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (3, 1))
    bundle, tau = tfermat.trace_rays(m, grid, o, d, 150e6, 1000.0, n_steps=4,
                                     method="leapfrog", interp="zp")
    assert bundle.points.device.type == tau.device.type == "cpu"
    orig, dirs = trays.make_ray_batch(torch.from_numpy(o), d)
    assert orig.device.type == dirs.device.type == "cpu"
    assert convert.field_from_numpy(np.zeros(3), device="cpu").device.type \
        == "cpu"
    assert tgather.probe_inputs(8, 128, "cpu")[0].device.type == "cpu"
