"""The C¹ field models of the ``interp`` argument, as the tracer and the
forward operators use them.

A model is the module of its row-gather evaluators (``row_setup``,
``row_plan``, ``interp_rows``, ``interp_rows_with_grad`` with its plain
version and its transpose, fresh or added into a table in place
(``interp_rows_with_grad_transpose_add_``), ``endpoint_plan``), the
contraction order of its value gather, and the linear map P from field
samples to its (nx*ny, nz) table with the transpose Pᵀ:

- ``"cubic"`` (the default everywhere): Catmull-Rom tricubic,
  ``core.tricubic``, 16 rows × 4 taps, z first; P is a free view of the
  field (a convolution kernel, no prefilter), Pᵀ too;
- ``"zp"`` / ``"zp<order>"``: Zwart-Powell box spline ⊗ quadratic z,
  ``core.boxspline``, 8 rows × 3 taps, xy first; P is ``prefilter`` and
  Pᵀ ``prefilter_transpose``.

Not ported yet: ``"zpc*"`` and ``"quadratic"`` (ROADMAP.md Queue 1 item
12, kernel K6); they raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from . import boxspline, tricubic
from .grids import Grid3D


@dataclasses.dataclass(frozen=True)
class FieldModel:
    rows: ModuleType        # core.tricubic or core.boxspline
    xy_first: bool          # contraction order of the value gather
    order: int | None       # zp xy-prefilter Neumann order; None: no filter

    def table(self, field_m: torch.Tensor, grid: Grid3D) -> torch.Tensor:
        """P: field samples (..., nx, ny, nz) → the (..., nx*ny, nz)
        table (leading axes, an ensemble's members, ride along)."""
        nx, ny, nz = grid.shape
        shape = field_m.shape[:-3] + (nx * ny, nz)
        if self.order is None:
            return field_m.reshape(shape)
        return boxspline.prefilter(field_m, self.order).reshape(shape)

    def table_t(self, table_ct: torch.Tensor, grid: Grid3D) -> torch.Tensor:
        """Pᵀ: a table cotangent (..., nx*ny, nz) → field cotangent."""
        ct = table_ct.reshape(table_ct.shape[:-2] + tuple(grid.shape))
        if self.order is None:
            return ct
        return boxspline.prefilter_transpose(ct, self.order)


def _not_ported(interp: str, item: str):
    return NotImplementedError(
        f"interp={interp!r} is not ported to ionotomo_tpu_torch yet "
        f"(ROADMAP.md {item}); the port has the tricubic model ('cubic') "
        f"and the zp model ('zp', 'zp<order>')")


def field_model(interp: str) -> FieldModel:
    """The model an ``interp`` string names; raises NotImplementedError
    for the models not ported yet and ValueError for anything else."""
    if interp == "cubic":
        return FieldModel(tricubic, False, None)
    if interp.startswith("zpc"):     # before "zp": shared prefix
        raise _not_ported(interp, "Queue 1 item 12, kernel K6")
    if interp.startswith("zp"):
        return FieldModel(boxspline, True, boxspline.zp_order(interp))
    if interp == "quadratic":
        raise _not_ported(interp, "Queue 1 item 12, kernel K6")
    raise ValueError(f"unknown interp: {interp!r}")
