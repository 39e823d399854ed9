"""Plain stencils of the two field models the cells run, and the zp
prefilter, written from their definitions.

``cubic``: separable Catmull-Rom cubic convolution (a = -0.5) over the
4×4×4 neighbourhood of a point's cell, the query clamped into the grid and
the base cell to [0, n−2], neighbour indices clamped (edge replicate). The
table is the field itself.

``zp``: the C¹ Zwart-Powell box spline in (x, y) (eight translates of the
canonical quadratic piece, reached through the element's D4 symmetry)
times a quadratic B-spline in z, around the nearest lattice point clamped
to [1, n−2]. The table is the prefiltered coefficient grid: the exact
inverse of the quadratic B-spline's sampling matrix along z (boundary rows
the identity), then the second-order Neumann series Σ_{j≤2} (I − A)^j of
the ZP sampling mask A (centre 1/2, 4-neighbours 1/8, edges replicated) in
(x, y).

A stencil is (flat table indices (P, T) int64, value weights (P, T)) and,
with ``grad``, the physical gradient weights (P, T, 3) [1/km]: the value
at a point is Σ_t w[t]·table.flat[idx[t]].

``tf32``: the control's precision. Every contraction's operands are
rounded to TF32 (10 mantissa bits), as a TF32 matrix unit rounds them.
"""
from __future__ import annotations

import functools
import importlib

import numpy as np
import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (ties away from zero), kept in
    float32."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x1000) & ~0x1FFF
    return r.view(torch.float32)


class _Round(torch.autograd.Function):
    """TF32 rounding whose tangents and cotangents are rounded too (a TF32
    contraction rounds the operands of its linearisation as well)."""

    @staticmethod
    def forward(x):
        return tf32_round(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)

    @staticmethod
    def jvp(ctx, t):
        return tf32_round(t)


def rnd(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _Round.apply(x) if tf32 else x


def _index_query(grid, points):
    t = (points - grid.origin) / grid.spacing
    n = torch.tensor(grid.shape, dtype=torch.float32, device=t.device)
    return torch.minimum(torch.maximum(t, torch.zeros_like(n)), n - 1.0), n


def _catmull_rom(u):
    u2, u3 = u * u, u * u * u
    w = torch.stack([0.5 * (-u3 + 2.0 * u2 - u),
                     0.5 * (3.0 * u3 - 5.0 * u2 + 2.0),
                     0.5 * (-3.0 * u3 + 4.0 * u2 + u),
                     0.5 * (u3 - u2)], -1)
    dw = torch.stack([0.5 * (-3.0 * u2 + 4.0 * u - 1.0),
                      0.5 * (9.0 * u2 - 10.0 * u),
                      0.5 * (-9.0 * u2 + 8.0 * u + 1.0),
                      0.5 * (3.0 * u2 - 2.0 * u)], -1)
    return w, dw


def cubic_stencil(grid, points: torch.Tensor, grad: bool = False):
    """The Catmull-Rom stencil of points (P, 3): T = 64 taps."""
    t, n = _index_query(grid, points)
    base = torch.minimum(torch.maximum(torch.floor(t), torch.zeros_like(n)),
                         n - 2.0)
    frac = t - base
    off = torch.arange(-1, 3, device=t.device)
    ns = torch.tensor(grid.shape, device=t.device)
    idx = torch.minimum(torch.clamp_min(base.long()[..., None] + off, 0),
                        ns[None, :, None] - 1)                # (P, 3, 4)
    _, ny, nz = grid.shape
    flat = ((idx[:, 0, :, None, None] * ny + idx[:, 1, None, :, None]) * nz
            + idx[:, 2, None, None, :]).reshape(-1, 64)
    (wx, dwx), (wy, dwy), (wz, dwz) = (_catmull_rom(frac[:, d])
                                       for d in range(3))

    def outer(a, b, c):
        return (a[:, :, None, None] * b[:, None, :, None]
                * c[:, None, None, :]).reshape(-1, 64)

    w = outer(wx, wy, wz)
    if not grad:
        return flat, w
    g = torch.stack([outer(dwx, wy, wz), outer(wx, dwy, wz),
                     outer(wx, wy, dwz)], -1) / grid.spacing
    return flat, w, g


# The ZP element's canonical piece (u+v > 0, u−v > 0): eight translates
# (dx, dy), the last of weight 0, and each translate's quadratic over the
# monomials (1, u, v, u², uv, v²), ×16.
_DX3 = np.asarray([-1, 0, 0, 0, 1, 1, 1, 0], np.float32)
_DY3 = np.asarray([0, -1, 0, 1, -1, 0, 1, 0], np.float32)
_CW3 = np.asarray([[2, -8, 0, 8, 0, 0], [2, 0, -8, -4, 8, 4],
                   [8, 0, 0, -8, 0, -8], [2, 0, 8, -4, -8, 4],
                   [0, 0, 0, 4, -8, 4], [2, 8, 0, 0, 0, -8],
                   [0, 0, 0, 4, 8, 4], [0, 0, 0, 0, 0, 0]],
                  np.float32) / 16.0                          # (8, 6)


def _zp_xy(u, v):
    """Translate offsets (P, 8) and weights with their u, v derivatives
    (P, 8), through the map T of each point's piece onto the canonical
    one: T = I, −I, or a quarter turn, so that uc = T (u, v)."""
    dev = u.device
    s1 = (u + v > 0).float()
    s2 = (u - v > 0).float()
    turn = torch.abs(s1 - s2)
    sg = 2.0 * s1 - 1.0
    a11, a12 = (1.0 - turn) * sg, turn * sg
    a21 = -a12
    uc = a11 * u + a12 * v
    vc = a21 * u + a11 * v
    one = torch.ones_like(u)
    cw = torch.from_numpy(_CW3).to(dev)
    mono = torch.stack([one, uc, vc, uc * uc, uc * vc, vc * vc], -1)
    w = mono @ cw.T
    d_uc = torch.stack([torch.zeros_like(u), one, torch.zeros_like(u),
                        2 * uc, vc, torch.zeros_like(u)], -1) @ cw.T
    d_vc = torch.stack([torch.zeros_like(u), torch.zeros_like(u), one,
                        torch.zeros_like(u), uc, 2 * vc], -1) @ cw.T
    # chain rule through uc = a11 u + a12 v, vc = a21 u + a11 v
    wu = a11[:, None] * d_uc + a21[:, None] * d_vc
    wv = a12[:, None] * d_uc + a11[:, None] * d_vc
    dx3 = torch.from_numpy(_DX3).to(dev)
    dy3 = torch.from_numpy(_DY3).to(dev)
    # a canonical translate (dx3, dy3) sits at Tᵀ (dx3, dy3) in the grid
    dx = (a11[:, None] * dx3 + a21[:, None] * dy3).round().long()
    dy = (a12[:, None] * dx3 + a11[:, None] * dy3).round().long()
    return dx, dy, w, wu, wv


def zp_stencil(grid, points: torch.Tensor, grad: bool = False):
    """The zp stencil of points (P, 3): T = 8 translates × 3 z taps = 24."""
    t, n = _index_query(grid, points)
    base = torch.minimum(torch.maximum(torch.round(t), torch.ones_like(n)),
                         n - 2.0)
    frac = t - base
    b = base.long()
    u, v, s = frac[:, 0], frac[:, 1], frac[:, 2]
    dx, dy, wxy, wu, wv = _zp_xy(u, v)
    nx, ny, nz = grid.shape
    ix = torch.clamp(b[:, 0:1] + dx, 0, nx - 1)
    iy = torch.clamp(b[:, 1:2] + dy, 0, ny - 1)
    iz = b[:, 2:3] + torch.arange(-1, 2, device=t.device)
    flat = ((ix * ny + iy) * nz)[:, :, None] + iz[:, None, :]  # (P, 8, 3)
    wz = torch.stack([0.5 * (0.5 - s) ** 2, 0.75 - s * s,
                      0.5 * (0.5 + s) ** 2], -1)
    dwz = torch.stack([s - 0.5, -2.0 * s, s + 0.5], -1)
    w = (wxy[:, :, None] * wz[:, None, :]).reshape(-1, 24)
    flat = flat.reshape(-1, 24)
    if not grad:
        return flat, w
    g = torch.stack([(wu[:, :, None] * wz[:, None, :]).reshape(-1, 24),
                     (wv[:, :, None] * wz[:, None, :]).reshape(-1, 24),
                     (wxy[:, :, None] * dwz[:, None, :]).reshape(-1, 24)],
                    -1) / grid.spacing
    return flat, w, g


@functools.lru_cache(maxsize=8)
def z_inverse(nz: int, device) -> torch.Tensor:
    """Exact inverse of the quadratic B-spline's sampling matrix along z:
    interior rows (c_{j−1} + 6 c_j + c_{j+1})/8, boundary rows the
    identity; inverted in float64, kept in float32."""
    b = np.zeros((nz, nz), np.float64)
    b[0, 0] = b[-1, -1] = 1.0
    i = np.arange(1, nz - 1)
    b[i, i - 1] = b[i, i + 1] = 1.0 / 8.0
    b[i, i] = 6.0 / 8.0
    return torch.from_numpy(np.linalg.inv(b).astype(np.float32)).to(device)


def _mask_xy(f: torch.Tensor) -> torch.Tensor:
    """The ZP sampling mask over (x, y), edges replicated: slices and
    concatenations only, so its transpose under autograd is plain
    additions with no atomics."""
    xm = torch.cat([f[..., :1, :, :], f[..., :-1, :, :]], dim=-3)
    xp = torch.cat([f[..., 1:, :, :], f[..., -1:, :, :]], dim=-3)
    ym = torch.cat([f[..., :, :1, :], f[..., :, :-1, :]], dim=-2)
    yp = torch.cat([f[..., :, 1:, :], f[..., :, -1:, :]], dim=-2)
    return 0.5 * f + 0.125 * (xm + xp + ym + yp)


def zp_prefilter(field: torch.Tensor, pz: torch.Tensor, tf32: bool = False
                 ) -> torch.Tensor:
    """Field samples (..., nx, ny, nz) → the zp coefficient grid."""
    c = torch.matmul(rnd(field, tf32), rnd(pz, tf32).T)
    acc, d = c, c
    for _ in range(2):
        d = d - _mask_xy(d)
        acc = acc + d
    return acc


def contract(table_flat: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
             tf32: bool = False) -> torch.Tensor:
    """Σ_t w[..., t]·table[..., idx[..., t]] for a table (B, V) or (V,)."""
    vals = table_flat[..., idx]
    return (rnd(vals, tf32) * rnd(w, tf32)).sum(-1)


def zp_table(field: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    return zp_prefilter(field, z_inverse(field.shape[-1], field.device), tf32)


class Model:
    """A field model: its stencil, and its table of a field (None: the
    field itself)."""

    def __init__(self, stencil, table=None):
        self.stencil, self._table = stencil, table

    def table(self, field: torch.Tensor, tf32: bool = False) -> torch.Tensor:
        return field if self._table is None else self._table(field, tf32)


MODELS = {"cubic": Model(cubic_stencil), "zp": Model(zp_stencil, zp_table)}


def model(name: str) -> Model:
    """The model ``name``: one of ``MODELS``, or the module
    ``tomobench.reference.model_<name>`` with its ``stencil`` and, where
    it has one, ``table``."""
    if name not in MODELS:
        mod = importlib.import_module(f"tomobench.reference.model_{name}")
        return Model(mod.stencil, getattr(mod, "table", None))
    return MODELS[name]
