"""Solution state container (port of ``ionotomo_tpu.inversion.solution``).

Holds the reconstruction per timestep plus convergence diagnostics as host
numpy arrays, with the reference's HDF5 layout, so a file written by either
package is read by the other. A field given as a tensor is copied to the
host; ``load`` puts the grid on ``device`` (the card unless named).
"""
from __future__ import annotations

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

from ..core.grids import Grid3D
from ..device import host


class Solution:
    """Reconstructed log-density fields m[Nt, nx, ny, nz] on a Grid3D."""

    def __init__(self, grid: Grid3D, m, diagnostics=None, config_json=""):
        self.grid = grid
        self.m = host(m)
        if self.m.ndim == 3:
            self.m = self.m[None]
        self.diagnostics = {k: host(v)
                            for k, v in dict(diagnostics or {}).items()}
        self.config_json = config_json

    @property
    def num_times(self):
        return self.m.shape[0]

    def ne(self, t=0):
        """Electron density field [m^-3] at timestep t."""
        from .. import constants
        return constants.K_NE * np.exp(self.m[t])

    def save(self, path):
        if h5py is None:
            raise RuntimeError("h5py unavailable")
        with h5py.File(path, "w") as f:
            f.attrs["config"] = self.config_json
            f.create_dataset("grid/origin", data=host(self.grid.origin))
            f.create_dataset("grid/spacing", data=host(self.grid.spacing))
            f.create_dataset("grid/shape",
                             data=np.asarray(self.grid.shape, np.int64))
            f.create_dataset("m", data=self.m)
            for k, v in self.diagnostics.items():
                f.create_dataset(f"diagnostics/{k}", data=np.asarray(v))

    @staticmethod
    def load(path, device=None):
        if h5py is None:
            raise RuntimeError("h5py unavailable")
        with h5py.File(path, "r") as f:
            grid = Grid3D.create(f["grid/origin"][:], f["grid/spacing"][:],
                                 tuple(f["grid/shape"][:]), device=device)
            diags = {}
            if "diagnostics" in f:
                for k in f["diagnostics"]:
                    diags[k] = f[f"diagnostics/{k}"][:]
            return Solution(grid, f["m"][:], diags,
                            str(f.attrs.get("config", "")))
