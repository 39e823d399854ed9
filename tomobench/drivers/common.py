"""What the drivers share: the world of a configuration and its noise-free
data, the program's views of the benchmark's inputs, and the bitwise
record of repeated units."""
from __future__ import annotations

import numpy as np
import torch

from ..worlds import analytic as W


class World:
    """The station array, directions, grid, prior mean and truth of a
    configuration's ``world`` entry."""

    def __init__(self, cfg: dict, dev):
        w = cfg["world"]
        self.cfg = w
        self.ants, self.dirs = W.make_rays(w["n_ants"], w["n_dirs"],
                                           w["array_seed"], w["spread_km"],
                                           w["zen_max"])
        self.grid = W.grid_enclosing_rays(self.ants, self.dirs, w["shape"],
                                          dev, w["max_length_km"],
                                          w["pad_km"])
        self.m_prior = W.chapman_log_field(self.grid)
        t = w["truth"]
        kmax = float(np.pi / float(self.grid.spacing.max()))
        self.modes = W.FourierModes(t["n_modes"], t["amplitude"],
                                    t["outer_scale_km"], kmax, t["seed"],
                                    dev)
        self.dev = dev
        self.n_dirs = w["n_dirs"]

    def shift_km(self, epoch: int) -> np.ndarray:
        return (np.asarray(self.cfg.get("wind_kmps", (0, 0, 0)), np.float64)
                * (epoch * self.cfg.get("dt_s", 0.0)))

    def truth_field(self, epoch: int = 0) -> torch.Tensor:
        """The truth's log density on the grid at an epoch."""
        modes = self.modes.shifted(self.shift_km(epoch))
        return (self.m_prior + modes.value(self.grid.points())
                .reshape(self.grid.shape)).contiguous()

    def clean_dtec(self, epoch: int = 0) -> torch.Tensor:
        """Noise-free bent-ray dTEC (Na, Nd) through the closed-form truth
        at an epoch."""
        w = self.cfg
        ne = W.analytic_ne(self.modes.shifted(self.shift_km(epoch)))
        o, d = W.ray_batch(self.ants, self.dirs, self.dev)
        tau = W.trace_tec_callable(ne, o, d, w["frequency_hz"],
                                   w["max_length_km"], w["trace_steps"])
        return W.paired(tau, self.n_dirs)

    def noise_std(self, clean: torch.Tensor) -> float:
        return float(self.cfg["noise_frac"] * clean.double().std(
            correction=0))


def sync(dev):
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev):
    """Hand the caching allocator's free blocks back to the card."""
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def generator(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))


def straight_points(world: World, n_samples: int):
    """The benchmark's own straight bundle: (points (R, S, 3), ds (R,))
    from the array, for the reference."""
    o, d = W.ray_batch(world.ants, world.dirs, world.dev)
    length = world.cfg["max_length_km"]
    s = torch.linspace(0.0, length, n_samples, device=world.dev)
    pts = o[:, None, :] + s[None, :, None] * d[:, None, :]
    ds = torch.full((o.shape[0],), length / (n_samples - 1),
                    device=world.dev)
    return pts, ds


def touched(world: World, model: str, n_samples: int) -> int:
    """Distinct table cells the stencils of the straight bundle's samples
    touch: what a gather over them has to read."""
    from ..reference.interp import model as field_model
    pts, _ = straight_points(world, n_samples)
    seen = torch.zeros(world.grid.num_voxels, dtype=torch.bool,
                       device=pts.device)
    for block in pts.reshape(-1, 3).split(1 << 16):
        idx, _ = field_model(model).stencil(world.grid, block)
        seen[idx.reshape(-1)] = True
    return int(seen.sum())


def port_grid(world: World):
    from ionotomo_tpu_torch.core.grids import Grid3D
    g = world.grid
    return Grid3D.create(g.origin, g.spacing, g.shape, device=g.device)


def port_bundle(world: World, n_samples: int):
    """The program's straight bundle of the array, by its own ray code."""
    from ionotomo_tpu_torch.geometry import rays
    a = torch.from_numpy(world.ants).to(world.dev)
    d = torch.from_numpy(world.dirs).to(world.dev)
    o, dv = rays.make_ray_batch(a, d)
    return rays.sample_straight_rays(o, dv, world.cfg["max_length_km"],
                                     n_samples)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bit patterns: bitwise equality, a NaN equal to
    the same NaN."""
    return t.contiguous().view(torch.int32)


class Repeats:
    """The bitwise record of repeated inputs, compared once the window has
    closed. A unit only hands its outputs over (references, no work on the
    card): the first output of each input, and the outputs of its 1st, 2nd,
    4th, 8th ... repeat, so a sample reaching to the window's end. A repeat
    that shares its first output's memory could not show a difference and
    counts as a mismatch."""

    def __init__(self):
        self.first, self.seen, self.later = {}, {}, []

    def record(self, key, outs):
        n = self.seen.get(key, 0)
        self.seen[key] = n + 1
        if n == 0:
            self.first[key] = tuple(outs)
        elif n & (n - 1) == 0:
            self.later.append((key, tuple(outs)))

    def mismatches(self) -> int:
        n = 0
        for key, outs in self.later:
            for a, b in zip(self.first[key], outs):
                n += int(a.data_ptr() == b.data_ptr()
                         or bool((_bits(a) != _bits(b)).any()))
        self.later.clear()
        return n


def rel_gap(a: torch.Tensor, b: torch.Tensor, base: torch.Tensor) -> float:
    """‖a − b‖ / ‖base‖ in float64."""
    return float(torch.linalg.norm((a.double() - b.double()).reshape(-1))
                 / torch.linalg.norm(base.double().reshape(-1)))


def sample(seed: int, tag: int, population, k: int) -> list:
    """k members of ``population`` drawn from the run's seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), tag])
    pop = list(population)
    return [pop[i] for i in sorted(rng.choice(len(pop), size=min(k, len(pop)),
                                              replace=False))]
