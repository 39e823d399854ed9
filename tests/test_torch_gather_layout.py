"""KG's and the permute's redesign checked on the CPU.

KG, the vector gather out[i, j] = table[idx[i, j], j], is the port's
counterpart of the JAX package's only Pallas kernel
(``bench/probe_gather.py:probe_mosaic_vector_gather``). Its plain version
is held to that probe's own form, ``jnp.take_along_axis(table, idx,
axis=0)`` on JAX's CPU, at ragged shapes, and the port's probe inputs to
the JAX probe's. The permute (``tricubic.build_point_order``'s inputs
into the point order) is held to a numpy sort and row gather on both
models. Both kernels copy bits, so every comparison is bitwise. Inputs
from ``np.random.default_rng``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ionotomo_tpu_torch.core import boxspline, tricubic
from ionotomo_tpu_torch.core.grids import Grid3D
from ionotomo_tpu_torch.probes import gather
from ionotomo_tpu_torch.testing import edge_case_points

torch.set_num_threads(2)

ROWS = (8, 300, 4097)


def _inputs(rows, width, seed):
    """A normal (rows, width) f32 table and (rows + 13, width) int32 row
    indices."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, width)).astype(np.float32)
    idx = rng.integers(0, rows, (rows + 13, width)).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("width", [1, 7, 129, 130])
@pytest.mark.parametrize("rows", ROWS)
def test_plain_kg_is_the_jax_probes_take_along_axis(rows, width):
    """Bitwise: the port's KG on CPU tensors (its plain version) against
    the JAX probe's gather, ``jnp.take_along_axis(table, idx, axis=0)``,
    with more index rows than table rows."""
    table, idx = _inputs(rows, width, seed=rows * width)
    got = gather.vector_gather(torch.from_numpy(table), torch.from_numpy(idx))
    want = np.asarray(jnp.take_along_axis(jnp.asarray(table),
                                          jnp.asarray(idx), axis=0))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,width", [(8, 128), (300, 7), (4097, 130)])
def test_probe_inputs_are_the_jax_probes(rows, width):
    """Bitwise: the port's probe inputs (``probe_inputs`` on the CPU) are
    the arrays the JAX probe draws (``bench/probe_gather.py:39-41``: a
    normal table and uniform row indices from ``default_rng(0)``, cast by
    ``jnp.asarray``), and KG's plain version on them is the probe's
    reference gather."""
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(size=(rows, width)), jnp.float32)
    idx2d = jnp.asarray(rng.integers(0, rows, (rows, width)), jnp.int32)
    t, i = gather.probe_inputs(rows, width, device="cpu")
    assert np.array_equal(t.numpy(), np.asarray(table))
    assert np.array_equal(i.numpy(), np.asarray(idx2d))
    assert np.array_equal(gather.vector_gather(t, i).numpy(), np.asarray(
        jnp.take_along_axis(table, idx2d, axis=0)))


@pytest.mark.parametrize("model", [boxspline, tricubic], ids=["zp", "cubic"])
def test_build_point_order_on_the_cpu_is_a_numpy_sort_and_gather(model):
    """Bitwise: ``build_point_order`` on CPU tensors against a numpy
    stable sort of each point's base cell (row ri[:, base] and z
    zi[:, 1], clamped, as row·nz + z) and its four inputs gathered in that
    order, at the edge-case points of a 12×10×14 grid and random ones."""
    shape, origin, spacing = (12, 10, 14), (-96.0, -40.0, 0.0), (16.0, 8.0,
                                                                 32.0)
    rng = np.random.default_rng(29)
    grid = Grid3D.create(origin, spacing, shape, device="cpu")
    hi = np.asarray(spacing) * (np.asarray(shape) - 1)
    pts = np.concatenate([
        edge_case_points(shape, origin, spacing, 1500, rng),
        np.asarray(origin) + rng.uniform(0, 1, (1003, 3)) * hi]
    ).astype(np.float32)
    setup = model.row_setup(grid, torch.from_numpy(pts))
    ri, wxy, zi, wz = (t.numpy() for t in setup)
    n_rows, nz = shape[0] * shape[1], shape[2]
    key = (np.clip(ri[:, model.BASE_TRANSLATE], 0, n_rows - 1).astype(
        np.int64) * nz + np.clip(zi[:, min(1, zi.shape[1] - 1)], 0, nz - 1))
    perm = np.argsort(key, kind="stable")
    po = tricubic.build_point_order(grid, torch.from_numpy(pts),
                                    model.POINT_RULE, model.base_cell,
                                    *setup)
    assert np.array_equal(po.order.numpy(), perm.astype(np.int32))
    for got, t in zip((po.ri, po.wxy, po.zi, po.wz), (ri, wxy, zi, wz)):
        assert got.is_contiguous()
        assert np.array_equal(got.numpy().view(np.int32),
                              t[perm].view(np.int32))
    assert po.of(*setup)
