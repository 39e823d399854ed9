"""The C¹ field models of the ``interp`` argument, as the tracer and the
forward operators use them.

A model is the module of its row-gather evaluators (``row_setup``,
``interp_rows``, ``interp_rows_with_grad`` with its plain version and, for
the models the operators take, ``row_plan``, ``endpoint_plan`` and the
transpose added into a table in place,
``interp_rows_with_grad_transpose_add_``), the contraction order of its
value gather, and the linear map P from field samples to its (nx*ny, nz)
table with the transpose Pᵀ, which the module owns (``prefilter`` /
``prefilter_transpose``, given the xy order where the model has one):

- ``"cubic"`` (the default everywhere): Catmull-Rom tricubic,
  ``core.tricubic``, 16 rows × 4 taps, z first; P is a free view of the
  field (a convolution kernel, no prefilter), Pᵀ too;
- ``"zp"`` / ``"zp<order>"``: Zwart-Powell box spline ⊗ quadratic z,
  ``core.boxspline``, 8 rows × 3 taps, xy first;
- ``"zpc"`` / ``"zpc<order>"``: Zwart-Powell box spline ⊗ Catmull-Rom z,
  ``core.zpcubic``, 8 rows × 4 taps, xy first;
- ``"quadratic"``: triquadratic B-spline, ``core.triquadratic``, 9 rows × 3
  taps, z first. The tracer takes it; the forward operators do not, as
  the reference's do not (``operator_model`` raises ValueError for it).
"""
from __future__ import annotations

import dataclasses
from types import ModuleType

import torch

from . import boxspline, triquadratic, tricubic, zpcubic
from .grids import Grid3D


@dataclasses.dataclass(frozen=True)
class FieldModel:
    rows: ModuleType        # the module of the model's evaluators
    xy_first: bool          # contraction order of the value gather
    p_args: tuple | None    # P's arguments after the field (zp/zpc: the
                            # xy Neumann order); None: P is a view
    operator: bool = True   # whether the forward operators take it

    def table(self, field_m: torch.Tensor, grid: Grid3D) -> torch.Tensor:
        """P: field samples (..., nx, ny, nz) → the (..., nx*ny, nz)
        table (leading axes, an ensemble's members, ride along)."""
        nx, ny, nz = grid.shape
        shape = field_m.shape[:-3] + (nx * ny, nz)
        if self.p_args is None:
            return field_m.reshape(shape)
        return self.rows.prefilter(field_m, *self.p_args).reshape(shape)

    def table_t(self, table_ct: torch.Tensor, grid: Grid3D) -> torch.Tensor:
        """Pᵀ: a table cotangent (..., nx*ny, nz) → field cotangent."""
        ct = table_ct.reshape(table_ct.shape[:-2] + tuple(grid.shape))
        if self.p_args is None:
            return ct
        return self.rows.prefilter_transpose(ct, *self.p_args)


def field_model(interp: str) -> FieldModel:
    """The model an ``interp`` string names; raises ValueError for
    anything else."""
    if interp == "cubic":
        return FieldModel(tricubic, False, None)
    if interp.startswith("zpc"):     # before "zp": shared prefix
        return FieldModel(zpcubic, True, (zpcubic.zpc_order(interp),))
    if interp.startswith("zp"):
        return FieldModel(boxspline, True, (boxspline.zp_order(interp),))
    if interp == "quadratic":
        return FieldModel(triquadratic, False, (), operator=False)
    raise ValueError(f"unknown interp: {interp!r}")


def operator_model(interp: str) -> FieldModel:
    """``field_model`` for the forward operators (``forward.tec``): the
    models the reference's operators take (``cubic``, ``zp*``, ``zpc*``);
    ValueError for ``quadratic``, as the reference raises, and for
    anything else."""
    model = field_model(interp)
    if not model.operator:
        raise ValueError(f"unknown interp: {interp!r} (the forward "
                         f"operators take 'cubic', 'zp*' and 'zpc*')")
    return model
