"""The least time the chip needs for a unit of work: each operation's f32
operations over the f32 peak or its bytes over the HBM bandwidth, whichever
is larger, summed over the unit's operations. Each input byte is counted
once and each output byte once, whatever an implementation reads again;
an operation's internal temporaries are not counted. The counts are of the
algorithm at the cell's shapes, so they read the same whatever kernel
implements it.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
67 TFLOP/s in f32 outside the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import math

F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


class Work:
    """A list of (operation, f32 operations, bytes), with its least time."""

    def __init__(self):
        self.ops = []

    def add(self, name: str, flops: float, nbytes: float, times: float = 1):
        if times:
            self.ops.append((name, flops * times, nbytes * times))
        return self

    def seconds(self) -> float:
        return sum(max(f / F32_FLOPS_PER_S, b / HBM_BYTES_PER_S)
                   for _, f, b in self.ops)


def rfft_pair(v: int, nz: int) -> tuple:
    """A real 3-D FFT of a field of v voxels, a multiply by a real
    half-spectrum and the inverse: 2.5·v·log2(v) operations each way and
    one a complex value; the field in and out, the half-spectrum in."""
    half = v // nz * (nz // 2 + 1)
    return 5.0 * v * math.log2(v) + 2.0 * half, 8.0 * v + 4.0 * half


def cg_update(v: int) -> tuple:
    """One CG iteration's vector work over v-vectors: x, r and p updated,
    two dot products; reads x, p, r, Ap and writes x, r, p."""
    return 10.0 * v, 28.0 * v


def axpy(v: int) -> tuple:
    """out = a + b over v-vectors."""
    return float(v), 12.0 * v


def zp_prefilter(v: int, nz: int) -> tuple:
    """The zp prefilter or its transpose: the z inverse (a dense nz×nz
    product a column) and two Neumann passes of the 5-point mask."""
    return 2.0 * nz * v + 16.0 * v, 8.0 * v + 4 * nz * nz


def operator(n_points: int, n_ends: int, n_rays: int, taps: int,
             touched: int, v: int, transpose=False, forward=False) -> tuple:
    """J, Jᵀ or the forward (g0 with the linearisation's n_e) of the paired
    Hermite dTEC over a bundle: ``taps`` multiply-adds a sample, four
    contractions (value, gradient) at each end sample, the quadrature;
    in: the tangent's ``touched`` table values (Jᵀ: the data), n_e at the
    samples (J, Jᵀ) and the end terms; out: the data (Jᵀ: a whole field
    of v voxels)."""
    flops = (n_points * (2.0 * taps + 4.0) + n_ends * (8.0 * taps + 12.0)
             + 4.0 * n_rays)
    if forward:
        flops += (n_points + n_ends) * 2.0                # the exps
    state = 0.0 if forward else 4.0 * (n_points + 2 * n_ends)
    if transpose:
        nbytes = 4.0 * n_rays + state + 4.0 * v
    else:
        nbytes = 4.0 * touched + state + 4.0 * n_rays
        if forward:
            nbytes += 4.0 * (n_points + 2 * n_ends)       # its n_e out
    return flops, nbytes
