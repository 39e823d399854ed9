"""Parity of the port's row-gather value map (ionotomo_tpu_torch.core.
tricubic.rows_value, the plain version of kernel K2 on the CPU) with the
JAX package's ``rows_value_p`` on the same numpy-seeded inputs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core import tricubic as jtri
from ionotomo_tpu_torch.core import tricubic as ttri

torch.set_num_threads(2)


def _inputs(k, l, n=500, rows=12 * 10, nz=16, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, nz)).astype(np.float32)
    ri = rng.integers(0, rows, (n, k)).astype(np.int32)
    wxy = rng.normal(size=(n, k)).astype(np.float32)
    z0 = rng.integers(0, nz - l + 1, (n, 1))
    zi = (z0 + np.arange(l)[None, :]).astype(np.int32)
    wz = rng.normal(size=(n, l)).astype(np.float32)
    return table, ri, wxy, zi, wz


@pytest.mark.parametrize("k,l,xy_first", [(8, 3, True), (16, 4, False),
                                          (8, 4, True)],
                         ids=["zp", "cubic", "zpc"])
def test_rows_value_matches_jax(k, l, xy_first):
    """The zp shape (K=8, L=3, xy-first), the cubic shape (K=16, L=4,
    z-first) and the zpc shape (K=8, L=4, xy-first). Tolerance
    1e-6·Σ|w_xy||w_z||T| per point (measured ~1e-7): K·L products summed
    in another order."""
    table, ri, wxy, zi, wz = _inputs(k, l)
    want = np.asarray(jtri.rows_value(jnp.asarray(table), jnp.asarray(ri),
                                      jnp.asarray(wxy), jnp.asarray(zi),
                                      jnp.asarray(wz), xy_first=xy_first))
    t = [torch.from_numpy(a) for a in (table, ri, wxy, zi, wz)]
    got = ttri.rows_value(*t, xy_first=xy_first).numpy()
    scale = np.einsum("nk,nl,nkl->n", np.abs(wxy), np.abs(wz),
                      np.abs(table[ri[:, :, None], zi[:, None, :]]))
    assert np.all(np.abs(got - want) <= 1e-6 * scale)
    ref = ttri.rows_value_ref(*t, xy_first=xy_first).numpy()
    np.testing.assert_array_equal(got, ref)      # CPU takes the plain path


def test_rows_value_empty_batch():
    table, ri, wxy, zi, wz = _inputs(8, 3, n=0)
    t = [torch.from_numpy(a) for a in (table, ri, wxy, zi, wz)]
    assert ttri.rows_value(*t, xy_first=True).shape == (0,)
