"""Dense Gaussian-process toolkit (port of
``ionotomo_tpu.utils.gaussian_process``).

Composable stationary kernels (squared exponential, rational quadratic,
the Matérn family, sums and products), exact GP regression through a
Cholesky factor, and marginal-likelihood hyperparameter fitting by Adam
over log-parameters with ``torch.autograd``. Used for screen-level fits
over (antenna, direction) coordinates, where N is small and dense linear
algebra is the right tool; the reference computes these outside any
kernel too, so the factorisations and solves are library calls
(``torch.linalg.cholesky``, ``torch.cholesky_solve``,
``torch.linalg.solve_triangular``). Inputs are tensors; outputs keep
their device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.precision import check_full_f32


# --- kernels -----------------------------------------------------------------


class Kernel:
    """Base: kernels are callables k(X1, X2) -> (N1, N2) and compose."""

    def __call__(self, x1, x2):
        raise NotImplementedError

    def __add__(self, other):
        return SumKernel(self, other)

    def __mul__(self, other):
        return ProductKernel(self, other)

    # hyperparameters as a (nested) dict of scalars
    def params(self) -> dict:
        raise NotImplementedError

    def with_params(self, p: dict) -> "Kernel":
        raise NotImplementedError


def _sqdist(x1, x2):
    x1 = torch.atleast_2d(x1)
    x2 = torch.atleast_2d(x2)
    d = x1[:, None, :] - x2[None, :, :]
    return torch.sum(d * d, dim=-1)


@dataclasses.dataclass
class SquaredExponential(Kernel):
    sigma: float = 1.0
    length_scale: float = 1.0

    def __call__(self, x1, x2):
        r2 = _sqdist(x1, x2)
        return self.sigma**2 * torch.exp(-0.5 * r2 / self.length_scale**2)

    def params(self):
        return {"sigma": self.sigma, "length_scale": self.length_scale}

    def with_params(self, p):
        return SquaredExponential(**p)


@dataclasses.dataclass
class RationalQuadratic(Kernel):
    sigma: float = 1.0
    length_scale: float = 1.0
    alpha: float = 1.0

    def __call__(self, x1, x2):
        r2 = _sqdist(x1, x2)
        return self.sigma**2 * (
            1.0 + 0.5 * r2 / (self.alpha * self.length_scale**2)
        ) ** (-self.alpha)

    def params(self):
        return {"sigma": self.sigma, "length_scale": self.length_scale,
                "alpha": self.alpha}

    def with_params(self, p):
        return RationalQuadratic(**p)


@dataclasses.dataclass
class Matern(Kernel):
    """Matérn ν ∈ {0.5, 1.5, 2.5} (the closed-form family)."""

    sigma: float = 1.0
    length_scale: float = 1.0
    nu: float = 1.5

    def __call__(self, x1, x2):
        r = torch.sqrt(torch.clamp(_sqdist(x1, x2), min=1e-30))
        x = r / self.length_scale
        if self.nu == 0.5:
            k = torch.exp(-x)
        elif self.nu == 1.5:
            a = math.sqrt(3.0) * x
            k = (1.0 + a) * torch.exp(-a)
        elif self.nu == 2.5:
            a = math.sqrt(5.0) * x
            k = (1.0 + a + a * a / 3.0) * torch.exp(-a)
        else:
            raise ValueError("nu must be 0.5, 1.5 or 2.5")
        return self.sigma**2 * k

    def params(self):
        return {"sigma": self.sigma, "length_scale": self.length_scale}

    def with_params(self, p):
        return Matern(nu=self.nu, **p)


@dataclasses.dataclass
class SumKernel(Kernel):
    a: Kernel
    b: Kernel

    def __call__(self, x1, x2):
        return self.a(x1, x2) + self.b(x1, x2)

    def params(self):
        return {"a": self.a.params(), "b": self.b.params()}

    def with_params(self, p):
        return SumKernel(self.a.with_params(p["a"]),
                         self.b.with_params(p["b"]))


@dataclasses.dataclass
class ProductKernel(Kernel):
    a: Kernel
    b: Kernel

    def __call__(self, x1, x2):
        return self.a(x1, x2) * self.b(x1, x2)

    def params(self):
        return {"a": self.a.params(), "b": self.b.params()}

    def with_params(self, p):
        return ProductKernel(self.a.with_params(p["a"]),
                             self.b.with_params(p["b"]))


# --- cho_solver equivalents -------------------------------------------------


def cho_solve_stack(k_matrix, y, jitter=1e-6):
    """Cholesky solve K x = y with a fixed relative jitter.

    k_matrix: (..., N, N) SPD (batched OK), y: (..., N) or (..., N, M).
    Returns (x, the lower Cholesky factor).
    """
    n = k_matrix.shape[-1]
    trace = torch.diagonal(k_matrix, dim1=-2, dim2=-1).sum(-1)
    k = k_matrix + jitter * trace[..., None, None] / n * torch.eye(
        n, dtype=k_matrix.dtype, device=k_matrix.device)
    chol = torch.linalg.cholesky(k)
    vector = y.ndim == k.ndim - 1
    x = torch.cholesky_solve(y[..., None] if vector else y, chol)
    return (x[..., 0] if vector else x), chol


def _log_2pi(like: torch.Tensor) -> torch.Tensor:
    """log(2π) rounded to the dtype first, as ``jnp.log(2.0 * jnp.pi)``."""
    return torch.log(torch.tensor(2.0 * math.pi, dtype=like.dtype,
                                  device=like.device))


def log_marginal_likelihood(kernel: Kernel, x, y, noise_std):
    """Exact GP log evidence: -½ yᵀK⁻¹y − ½ log|K| − N/2 log 2π."""
    n = x.shape[0]
    k = kernel(x, x) + (noise_std**2) * torch.eye(n, dtype=x.dtype,
                                                   device=x.device)
    alpha, chol = cho_solve_stack(k, y)
    return (-0.5 * torch.dot(y, alpha)
            - torch.sum(torch.log(torch.diagonal(chol)))
            - 0.5 * n * _log_2pi(y))


def gp_predict(kernel: Kernel, x, y, noise_std, x_star):
    """Posterior mean and variance at x_star."""
    check_full_f32()
    n = x.shape[0]
    k = kernel(x, x) + (noise_std**2) * torch.eye(n, dtype=x.dtype,
                                                   device=x.device)
    alpha, chol = cho_solve_stack(k, y)
    ks = kernel(x, x_star)                      # (N, M)
    mean = ks.T @ alpha
    v = torch.linalg.solve_triangular(chol, ks, upper=False)
    var = torch.clamp(torch.diagonal(kernel(x_star, x_star))
                      - torch.sum(v * v, dim=0), min=0.0)
    return mean, var


def _leaves(p: dict, prefix=()):
    """(path, value) of a nested parameter dict, keys sorted (the order
    the reference's ``ravel_pytree`` flattens them in)."""
    for key in sorted(p):
        if isinstance(p[key], dict):
            yield from _leaves(p[key], prefix + (key,))
        else:
            yield prefix + (key,), p[key]


def _nested(paths, values) -> dict:
    out = {}
    for path, v in zip(paths, values):
        d = out
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = v
    return out


def fit_hyperparameters(kernel: Kernel, x, y, noise_std, steps=200,
                        lr=5e-2):
    """Maximise the marginal likelihood over log-hyperparameters: ``steps``
    Adam steps, each a gradient of -log evidence by ``torch.autograd``,
    in f32 as the reference's scan carries them (the step count too, so
    the bias corrections are f32 powers).

    Returns (fitted kernel, -log evidence at the start of the last step,
    before its update: the reference's ``losses[-1]``).
    """
    paths, values = zip(*_leaves(kernel.params()))
    flat = torch.log(torch.as_tensor([float(v) for v in values],
                                     dtype=x.dtype, device=x.device))

    def neg_lml(flat_logp):
        k = kernel.with_params(_nested(paths, torch.exp(flat_logp)))
        return -log_marginal_likelihood(k, x, y, noise_std)

    m = torch.zeros_like(flat)
    v = torch.zeros_like(flat)
    t = torch.zeros((), dtype=flat.dtype, device=flat.device)
    b1 = torch.tensor(0.9, dtype=flat.dtype, device=flat.device)
    b2 = torch.tensor(0.999, dtype=flat.dtype, device=flat.device)
    loss = None
    for _ in range(steps):
        p = flat.detach().requires_grad_(True)
        loss = neg_lml(p)
        (g,) = torch.autograd.grad(loss, p)
        t = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        flat = flat - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    fitted = kernel.with_params(_nested(paths, torch.exp(flat)))
    return fitted, float(loss.detach())
