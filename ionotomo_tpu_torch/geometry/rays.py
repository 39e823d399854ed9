"""Straight-line ray sampling, ray batches and the reference-parity
facade (port of ``ionotomo_tpu.geometry.rays``).

A ``RayBundle`` — a flat batch of rays plus quadrature geometry — is the
currency of the forward operators. Tensors keep their device; numpy inputs
go to the device of the tensor beside them (for bent rays, the grid's), or
to the card when there is none (``device.as_tensor``). ``inner_bundle``
subsamples a bundle for mixed-fidelity solves; ``calc_rays`` builds the
(antenna × direction) rays, straight or bent through
``geometry.fermat.trace_rays``.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import constants
from ..device import as_tensor


@dataclasses.dataclass(frozen=True)
class RayBundle:
    """A flat batch of sampled rays.

    points:  (R, N, 3) sample positions [km]
    ds:      (R,) arc-length spacing between consecutive samples [km]
             (uniform per ray; bent rays are reparametrised to uniform s)
    """

    points: torch.Tensor
    ds: torch.Tensor

    @property
    def num_rays(self) -> int:
        return self.points.shape[0]

    @property
    def num_samples(self) -> int:
        return self.points.shape[1]

    def step(self, t: int) -> "RayBundle":
        """Step t of a stacked bundle (points (Nt, R, N, 3), ds (Nt, R)),
        as ``parallel.sharding.ShardedRayBundle.step`` of a sharded one."""
        return RayBundle(points=self.points[t], ds=self.ds[t])


def _pair(a, b):
    """Two float32 tensors on one device: the first tensor's, else the
    card."""
    dev = next((x.device for x in (a, b) if isinstance(x, torch.Tensor)),
               None)
    return as_tensor(a, device=dev), as_tensor(b, device=dev)


def sample_straight_rays(origins, directions,
                         max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
                         n_samples=constants.DEFAULT_N_SAMPLES) -> RayBundle:
    """Sample straight rays: origins (R,3), unit directions (R,3) → RayBundle.

    ``n_samples`` should be odd so composite Simpson quadrature applies
    exactly (constants.DEFAULT_N_SAMPLES = 129).
    """
    origins, directions = _pair(origins, directions)
    s = torch.linspace(0.0, max_length_km, n_samples, dtype=torch.float32,
                       device=origins.device)
    pts = origins[:, None, :] + s[None, :, None] * directions[:, None, :]
    ds = torch.full((origins.shape[0],), max_length_km / (n_samples - 1),
                    dtype=torch.float32, device=origins.device)
    return RayBundle(points=pts, ds=ds)


def inner_bundle(bundle: RayBundle, n_inner: int) -> RayBundle:
    """Coarse subsample of a uniformly-sampled bundle: every k-th sample,
    the endpoints kept, ds × k, for (R, N, 3) and stacked (Nt, R, N, 3)
    bundles alike (straight or bent: both are uniform in arc length).
    Requires (N−1) divisible by (n_inner−1). A ray-sharded bundle
    (``parallel.sharding.ShardedRayBundle``) is subsampled shard by
    shard."""
    if not isinstance(bundle, RayBundle):
        return bundle.map(lambda b: inner_bundle(b, n_inner))
    n = bundle.points.shape[-2]
    if not 1 < n_inner < n:
        raise ValueError(f"inner_bundle: need 1 < n_inner={n_inner} < "
                         f"n_samples={n}")
    stride, rem = divmod(n - 1, n_inner - 1)
    if rem:
        raise ValueError(
            f"inner_bundle: n_samples-1={n - 1} not divisible by "
            f"n_inner-1={n_inner - 1} (try n_inner in "
            f"{[1 + (n - 1) // k for k in (2, 4) if (n - 1) % k == 0]})")
    return RayBundle(points=bundle.points[..., ::stride, :],
                     ds=bundle.ds * stride)


def make_ray_batch(antennas_enu, directions_enu):
    """Cartesian product (Na,3)×(Nd,3) → flat (Na*Nd, 3) origin/dir arrays.

    Row-major over (antenna, direction): ray r = i*Nd + k, matching the
    dTEC referencing convention in forward.tec.
    """
    ants, dirs = _pair(antennas_enu, directions_enu)
    na, nd = ants.shape[0], dirs.shape[0]
    origins = torch.repeat_interleave(ants, nd, dim=0)
    directions = dirs.repeat(na, 1)
    return origins, directions


def calc_rays(antennas_enu, directions_enu, ne_field_m=None, grid=None,
              frequency_hz=None, straight_line_approx=True,
              max_length_km=constants.DEFAULT_MAX_LENGTH_KM,
              n_samples=constants.DEFAULT_N_SAMPLES,
              method="leapfrog") -> RayBundle:
    """The reference's facade over the ray subsystem: the (antenna ×
    direction) product of ``make_ray_batch``, sampled straight
    (``sample_straight_rays``) or traced bent through ``ne_field_m`` on
    ``grid`` (``fermat.trace_rays`` with n_samples − 1 steps and the path
    kept, on the default tricubic model: K1c on the card, K1r with
    ``method="rk4"``). Returns a RayBundle (Na*Nd, N, 3), row-major over
    (antenna, direction)."""
    if straight_line_approx:
        origins, dvecs = make_ray_batch(antennas_enu, directions_enu)
        return sample_straight_rays(origins, dvecs, max_length_km,
                                    n_samples)
    if ne_field_m is None or grid is None or frequency_hz is None:
        raise ValueError("bent rays need ne_field_m, grid, frequency_hz")
    from .fermat import trace_rays

    origins, dvecs = make_ray_batch(
        as_tensor(antennas_enu, device=grid.device),
        as_tensor(directions_enu, device=grid.device))
    bundle, _ = trace_rays(ne_field_m, grid, origins, dvecs, frequency_hz,
                           max_length_km, n_steps=n_samples - 1,
                           keep_path=True, method=method)
    return bundle


def trapezoid_weights(n_samples: int, dtype=torch.float32, device=None):
    """Composite trapezoid weights [1/2, 1, ..., 1, 1/2] — the basis of
    the Hermite TEC quadrature (forward.tec.tec_hermite)."""
    if n_samples < 2:
        raise ValueError("need >= 2 samples")
    i = torch.arange(n_samples, device=device)
    w = torch.where((i == 0) | (i == n_samples - 1), 0.5, 1.0)
    return w.to(dtype)


def simpson_weights(n_samples: int, dtype=torch.float32, device=None):
    """Composite Simpson weights [1,4,2,...,4,1]/3 for odd n; trapezoid
    fallback on the last interval for even n.

    Built by ``torch.where`` over the sample index, as the trapezoid
    weights are: assigning a Python scalar into a CUDA tensor copies it
    from the host and waits for the card, and the linearised operator
    builds these weights in every application."""
    if n_samples < 2:
        raise ValueError("need >= 2 samples")
    i = torch.arange(n_samples, device=device)
    if n_samples % 2 == 1:
        w = torch.where(i % 2 == 1, 4.0, 2.0)
        w = torch.where((i == 0) | (i == n_samples - 1), 1.0, w)
        return w.to(dtype) / 3.0
    # even: Simpson on first n-1 points + trapezoid on final interval
    w = simpson_weights(n_samples - 1, dtype, device)
    w = torch.cat([w, torch.zeros((1,), dtype=dtype, device=device)])
    return w + torch.where(i >= n_samples - 2, 0.5, 0.0).to(dtype)
