"""The analytic worlds of configs 4 and 5, frozen here so that no change to
the measured package can move the benchmark's inputs.

A world is a station array, a set of near-zenith directions, the grid that
encloses their 1,000 km rays, a Chapman prior mean on it, and a truth: a
closed-form Chapman layer times exp of a band-limited von Karman
Fourier-mode sum (``FourierModes``). Its value and gradient exist
everywhere in closed form, so no interpolation model of the solver defines
reality. Data are bent-ray TEC through that closed form, by a leapfrog
tracer with the Hermite TEC rule, paired against antenna 0.

Everything is plain PyTorch in float32 with TF32 off, on the device given.
The arithmetic follows the port's ``configs``, ``models.chapman``,
``models.turbulence`` and ``geometry.fermat._trace_impl`` as they stood
when the benchmark was written.
"""
from __future__ import annotations

import numpy as np
import torch

K_NE = 1e11
KAPPA = 8.98 * 8.98
KM_TO_M = 1.0e3
TEC_SCALE = 1.0e13


class Grid:
    """Axis-aligned regular grid: ``origin`` and ``spacing`` (3,) float32
    tensors [km], ``shape`` a tuple of ints."""

    def __init__(self, origin, spacing, shape):
        self.origin, self.spacing = origin, spacing
        self.shape = tuple(int(s) for s in shape)

    @staticmethod
    def from_bounds(lo, hi, shape, device) -> "Grid":
        lo = torch.tensor(np.asarray(lo, np.float32), device=device)
        hi = torch.tensor(np.asarray(hi, np.float32), device=device)
        n = torch.tensor([max(s - 1, 1) for s in shape], dtype=torch.float32,
                         device=device)
        return Grid(lo, (hi - lo) / n, shape)

    @property
    def device(self):
        return self.origin.device

    @property
    def num_voxels(self) -> int:
        return int(np.prod(self.shape))

    def axes(self):
        return tuple(self.origin[d] + self.spacing[d] * torch.arange(
            self.shape[d], dtype=torch.float32, device=self.device)
            for d in range(3))

    def points(self) -> torch.Tensor:
        """Every voxel's position, (nx·ny·nz, 3), x-major."""
        return torch.stack(torch.meshgrid(*self.axes(), indexing="ij"),
                           dim=-1).reshape(-1, 3)


def make_rays(n_ants, n_dirs, seed=0, spread_km=150.0, zen_max=0.6):
    """Antenna ENU positions (n_ants, 3) and near-zenith unit directions
    (n_dirs, 3), numpy float32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    ants = np.concatenate([rng.uniform(-spread_km, spread_km, (n_ants, 2)),
                           np.zeros((n_ants, 1))], -1).astype(np.float32)
    zen = rng.uniform(0.05, zen_max, n_dirs)
    az = rng.uniform(0, 2 * np.pi, n_dirs)
    dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                     np.cos(zen)], -1).astype(np.float32)
    return ants, dirs


def grid_enclosing_rays(ants, dirs, shape, device, max_length_km=1000.0,
                        pad_km=25.0, h_min_km=0.0) -> Grid:
    """The grid that encloses every (antenna, direction) ray plus padding."""
    ants = np.atleast_2d(np.asarray(ants, np.float64))
    dirs = np.asarray(dirs, np.float64).reshape(-1, 3)
    ends = ants[:, None, :] + max_length_km * dirs[None, :, :]
    pts = np.concatenate([np.broadcast_to(ants[:, None, :], ends.shape)
                          .reshape(-1, 3), ends.reshape(-1, 3)], axis=0)
    lo = pts.min(axis=0) - pad_km
    hi = pts.max(axis=0) + pad_km
    lo[2] = min(lo[2], h_min_km)
    return Grid.from_bounds(lo, hi, shape, device)


def chapman_ne(h, n_peak=1.0e12, h_peak_km=350.0, scale_km=80.0):
    z = (h - h_peak_km) / scale_km
    return n_peak * torch.exp(0.5 * (1.0 - z - torch.exp(-z)))


def chapman_log_field(grid: Grid) -> torch.Tensor:
    """The Chapman prior mean m = log(n_e/K_NE) on the grid, contiguous."""
    prof = chapman_ne(grid.axes()[2])
    m = torch.log(torch.clamp_min(prof / K_NE, 1e-37))
    return m[None, None, :].expand(grid.shape).contiguous()


def chapman_value_grad(x: torch.Tensor):
    """The flat-Earth Chapman layer and its gradient at points (R, 3):
    (n_e (R,), grad n_e (R, 3)) in m^-3 and m^-3/km."""
    h = x[:, 2]
    z = (h - 350.0) / 80.0
    e = torch.exp(-z)
    ne = 1.0e12 * torch.exp(0.5 * (1.0 - z - e))
    zero = torch.zeros_like(h)
    return ne, torch.stack([zero, zero, ne * 0.5 * (e - 1.0) / 80.0], -1)


class FourierModes:
    """m_pert(x) = a · Σ_j cos(k_j·x + φ_j), a = amplitude·sqrt(2/K): a
    band-limited von Karman realization drawn by numpy from ``seed``."""

    PASS_ELEMENTS = 1 << 27

    def __init__(self, n_modes, amplitude, outer_scale_km, kmax, seed,
                 device, inner_scale_km=2.0):
        rng = np.random.default_rng(seed)
        k0 = 2 * np.pi / outer_scale_km
        li = inner_scale_km / (2 * np.pi)
        kt = np.linspace(0.0, kmax, 4097)
        pdf = kt**2 * (kt**2 + k0**2) ** (-11.0 / 6.0) \
            * np.exp(-((kt * li) ** 2))
        cdf = np.cumsum(pdf)
        cdf = cdf / cdf[-1]
        kmag = np.interp(rng.uniform(size=n_modes), cdf, kt)
        u = rng.normal(size=(n_modes, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        self.ks = torch.tensor((kmag[:, None] * u).astype(np.float32),
                               device=device)
        self.phases = torch.tensor(
            rng.uniform(0, 2 * np.pi, n_modes).astype(np.float32),
            device=device)
        self.amp = float(np.float32(amplitude * np.sqrt(2.0 / n_modes)))

    def shifted(self, dx) -> "FourierModes":
        """The world advected rigidly by ``dx`` km: a phase shift."""
        out = object.__new__(FourierModes)
        dx = torch.tensor(np.asarray(dx, np.float32), device=self.ks.device)
        out.ks, out.amp = self.ks, self.amp
        out.phases = self.phases - self.ks @ dx
        return out

    def _chunks(self, pts):
        return pts.split(max(1, self.PASS_ELEMENTS // self.ks.shape[0]))

    def value(self, pts: torch.Tensor) -> torch.Tensor:
        return self.amp * torch.cat([
            torch.cos(p @ self.ks.T + self.phases).sum(-1)
            for p in self._chunks(pts)])

    def value_and_grad(self, pts: torch.Tensor):
        vals, grads = [], []
        for p in self._chunks(pts):
            th = p @ self.ks.T + self.phases
            vals.append(torch.cos(th).sum(-1))
            grads.append(-(torch.sin(th) @ self.ks))
        return self.amp * torch.cat(vals), self.amp * torch.cat(grads)


def analytic_ne(modes: FourierModes):
    """x (R, 3) → (n_e, grad n_e): Chapman × exp(m_pert), exact gradient."""
    def ne_and_grad(x):
        nb, gb = chapman_value_grad(x)
        mp, gmp = modes.value_and_grad(x)
        e = torch.exp(mp)
        return nb * e, e[:, None] * (gb + nb[:, None] * gmp)
    return ne_and_grad


def ray_batch(ants, dirs, device):
    """The row-major (antenna × direction) batch: ray r = i·Nd + k."""
    a = torch.from_numpy(np.asarray(ants, np.float32)).to(device)
    d = torch.from_numpy(np.asarray(dirs, np.float32)).to(device)
    return (torch.repeat_interleave(a, d.shape[0], dim=0),
            d.repeat(a.shape[0], 1))


def trace_tec_callable(ne_and_grad, origins, directions, frequency_hz,
                       max_length_km, n_steps) -> torch.Tensor:
    """TEC per ray (R,) in working units through a closed-form field, by
    velocity-Verlet leapfrog with the Hermite TEC rule per step."""
    dev = origins.device
    h = torch.tensor(np.float32(max_length_km / n_steps), device=dev)
    inv_f2 = torch.tensor(np.float32(1.0 / (frequency_hz * frequency_hz)),
                          device=dev)
    w = KAPPA * inv_f2
    tec_unit = KM_TO_M / TEC_SCALE

    def rhs(x, p):
        ne, gne = ne_and_grad(x)
        clipped = 1.0 - w * ne <= 1e-6
        n = torch.sqrt(torch.clamp_min(1.0 - w * ne, 1e-6))
        gn = torch.where(clipped[:, None], 0.0, (-0.5 * w / n)[:, None] * gne)
        t = p / torch.linalg.norm(p, dim=-1, keepdim=True)
        return gn, ne, (gne * t).sum(-1)

    ne0, _ = ne_and_grad(origins)
    wf = KAPPA / (frequency_hz * frequency_hz)
    n0 = torch.sqrt(torch.clamp_min(1.0 - wf * ne0, 1e-6))
    p = n0[:, None] * directions
    gn, ne, dne = rhs(origins, p)
    x = origins
    tau = torch.zeros(origins.shape[0], dtype=torch.float32, device=dev)
    for _ in range(n_steps):
        p_half = p + (0.5 * h) * gn
        x = x + h * (p_half / torch.linalg.norm(p_half, dim=-1, keepdim=True))
        gn_new, ne_new, dne_new = rhs(x, p_half)
        p = p_half + (0.5 * h) * gn_new
        tau = tau + ((0.5 * h) * (ne + ne_new)
                     + (h * h / 12.0) * (dne - dne_new)) * tec_unit
        gn, ne, dne = gn_new, ne_new, dne_new
    return tau


def paired(tau: torch.Tensor, n_dirs: int) -> torch.Tensor:
    """TEC per ray → dTEC against antenna 0, (Na, Nd)."""
    t = tau.reshape(-1, n_dirs)
    return t - t[0:1]

