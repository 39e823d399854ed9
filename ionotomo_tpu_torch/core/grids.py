"""Regular 3D grid specification (port of ``ionotomo_tpu.core.grids``).

The grid is a frozen dataclass of tensors with a static ``shape``; fields
are plain tensors of shape ``grid.shape`` passed alongside the spec. The
device of ``origin``/``spacing`` is the device of the grid.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _vec3(x, device) -> torch.Tensor:
    """A (3,) float32 tensor (a copy) on ``device`` from a tensor or any
    array-like."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).clone()
    return torch.tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Axis-aligned regular grid.

    ``origin``/``spacing`` are (3,) float32 tensors [km]; ``shape`` is a
    tuple of Python ints.
    """

    origin: torch.Tensor   # (3,) physical coordinate of voxel (0,0,0) [km]
    spacing: torch.Tensor  # (3,) voxel pitch per axis [km]
    shape: Tuple[int, int, int]

    @staticmethod
    def create(origin, spacing, shape, device=None) -> "Grid3D":
        return Grid3D(origin=_vec3(origin, device),
                      spacing=_vec3(spacing, device),
                      shape=tuple(int(s) for s in shape))

    @staticmethod
    def from_bounds(lo, hi, shape, device=None) -> "Grid3D":
        lo = _vec3(lo, device)
        hi = _vec3(hi, device)
        shape = tuple(int(s) for s in shape)
        n = torch.tensor([max(s - 1, 1) for s in shape], dtype=torch.float32,
                         device=device)
        return Grid3D(origin=lo, spacing=(hi - lo) / n, shape=shape)

    @property
    def device(self) -> torch.device:
        return self.origin.device

    @property
    def num_voxels(self) -> int:
        nx, ny, nz = self.shape
        return nx * ny * nz

    def to(self, device) -> "Grid3D":
        return Grid3D(self.origin.to(device), self.spacing.to(device),
                      self.shape)

    def axes(self):
        """Per-axis coordinate vectors."""
        return tuple(
            self.origin[d] + self.spacing[d] * torch.arange(
                self.shape[d], dtype=torch.float32, device=self.device)
            for d in range(3)
        )

    def upper(self) -> torch.Tensor:
        n = torch.tensor([s - 1 for s in self.shape], dtype=torch.float32,
                         device=self.device)
        return self.origin + self.spacing * n

    def world_to_index(self, points: torch.Tensor) -> torch.Tensor:
        """Map physical points (..., 3) to fractional voxel indices."""
        return (points - self.origin) / self.spacing

    def meshgrid(self) -> np.ndarray:
        """Dense (nx,ny,nz,3) coordinate lattice. Host-side / setup only."""
        ax = [a.cpu().numpy() for a in self.axes()]
        X, Y, Z = np.meshgrid(*ax, indexing="ij")
        return np.stack([X, Y, Z], axis=-1)


def save_field(path, grid: Grid3D, field, name="field", attrs=None):
    """Persist (grid, field) to HDF5."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("grid/origin", data=grid.origin.cpu().numpy())
        f.create_dataset("grid/spacing", data=grid.spacing.cpu().numpy())
        f.create_dataset("grid/shape",
                         data=np.asarray(grid.shape, np.int64))
        f.create_dataset(name, data=torch.as_tensor(field).cpu().numpy())
        f.attrs["field_name"] = name
        for k, v in (attrs or {}).items():
            f.attrs[k] = v


def load_field(path):
    """Returns (Grid3D, field ndarray, attrs dict)."""
    import h5py

    with h5py.File(path, "r") as f:
        grid = Grid3D.create(f["grid/origin"][:], f["grid/spacing"][:],
                             tuple(int(s) for s in f["grid/shape"][:]))
        name = f.attrs.get("field_name", "field")
        field = f[name][:]
        attrs = {k: f.attrs[k] for k in f.attrs if k != "field_name"}
    return grid, field, attrs
