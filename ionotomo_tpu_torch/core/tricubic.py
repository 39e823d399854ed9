"""The row-gather value map (port of ``rows_value`` from
``ionotomo_tpu.core.tricubic``).

``rows_value`` is the forward of the JAX package's custom primitive
``rows_value_p``: out[n] = Σ_k wxy[n,k] Σ_l wz[n,l] · table[ri[n,k],
zi[n,l]]. On a CUDA tensor it launches kernel K2; on a CPU tensor it runs
``rows_value_ref``, the port of ``_rows_value_impl``'s unbatched branch.

Not ported yet: the transpose (K3) and the member-axis batching rule
(ROADMAP.md Queue 2, K3; EnKF), and the tricubic field model itself
(Queue 1 item 6; K5).
"""
from __future__ import annotations

import torch

from .. import kernels
from .precision import check_full_f32


def _z_band(idx_z: torch.Tensor, w: torch.Tensor, nz: int) -> torch.Tensor:
    """Dense (N, nz) vector with w[:, o] at positions idx_z[:, o]."""
    lanes = torch.arange(nz, dtype=torch.int32, device=w.device)[None, :]
    band = torch.zeros((idx_z.shape[0], nz), dtype=w.dtype, device=w.device)
    for o in range(w.shape[1]):
        band = band + torch.where(lanes == idx_z[:, o][:, None],
                                  w[:, o][:, None], 0.0)
    return band


def rows_value_ref(table, ri, wxy, zi, wz, xy_first: bool) -> torch.Tensor:
    """Plain PyTorch version of K2: the unbatched branch of the
    reference's ``_rows_value_impl`` (whole rows gathered, contracted
    against a dense z band)."""
    check_full_f32()
    nz = table.shape[-1]
    rows = table[ri.long()]                              # (N,K,nz)
    band = _z_band(zi, wz, nz)                           # (N,nz)
    if xy_first:    # the box spline's order
        s = torch.einsum("nkz,nk->nz", rows, wxy)
        return torch.einsum("nz,nz->n", s, band)
    pencil = torch.einsum("nkz,nz->nk", rows, band)     # tricubic order
    return torch.sum(pencil * wxy, dim=-1)


def rows_value(table, ri, wxy, zi, wz, xy_first: bool) -> torch.Tensor:
    """Row-gather value map; kernel K2 on CUDA, ``rows_value_ref`` on the
    CPU. table (R, nz); ri (N, K) int32; wxy (N, K); zi (N, L) int32;
    wz (N, L) → (N,)."""
    if table.is_cuda:
        return kernels.rows_value_fwd(table, ri, wxy, zi, wz, xy_first)
    return rows_value_ref(table, ri, wxy, zi, wz, xy_first)
