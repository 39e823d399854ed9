"""Each fault a cell can have, planted under the timed path, turns its
``correct`` false: a run driven end to end on the CPU at tiny sizes with
the cell's own limits."""
from __future__ import annotations

import pytest
import torch

from conftest import workloads


def _unchanged_solve(monkeypatch):
    """A solve that returns its state unchanged: the field it started
    from, its residual as the solver reports it."""
    from ionotomo_tpu_torch.inversion import solvers
    real = solvers.map_gauss_newton

    def fake(grid, rays, d_obs, noise_std, m_prior, cov, *a, **kw):
        res = real(grid, rays, d_obs, noise_std, m_prior, cov, *a, **kw)
        start = kw.get("m0") if kw.get("m0") is not None else m_prior
        return res._replace(m=start.clone())

    monkeypatch.setattr(solvers, "map_gauss_newton", fake)


def _altered_field(monkeypatch):
    """A solve whose field is altered where it is produced: its update
    off by 1 %."""
    from ionotomo_tpu_torch.inversion import solvers
    real = solvers.map_gauss_newton

    def fake(grid, rays, d_obs, noise_std, m_prior, cov, *a, **kw):
        res = real(grid, rays, d_obs, noise_std, m_prior, cov, *a, **kw)
        return res._replace(m=res.m + 0.01 * (res.m - m_prior))

    monkeypatch.setattr(solvers, "map_gauss_newton", fake)


def _altered_tec(monkeypatch):
    """A trace whose TEC is altered where it is produced: one ray's by
    0.1 %."""
    from ionotomo_tpu_torch.geometry import fermat
    real = fermat.trace_rays

    def fake(*a, **kw):
        bundle, tau = real(*a, **kw)
        tau = tau.clone()
        tau[len(tau) // 2] *= 1.001
        return bundle, tau

    monkeypatch.setattr(fermat, "trace_rays", fake)


def _unchanged_ray(monkeypatch):
    """A trace that returns its rays' state unchanged: each endpoint at
    its origin."""
    from ionotomo_tpu_torch.geometry import fermat
    from ionotomo_tpu_torch.geometry.rays import RayBundle
    real = fermat.trace_rays

    def fake(field, grid, origins, *a, **kw):
        bundle, tau = real(field, grid, origins, *a, **kw)
        pts = torch.stack([origins, origins], dim=1)
        return RayBundle(points=pts, ds=bundle.ds), tau

    monkeypatch.setattr(fermat, "trace_rays", fake)


FAULTS = [
    ("c4_cubic256.map_solve", _unchanged_solve),
    ("c4_cubic256.map_solve", _altered_field),
    ("c5_zp128.bent_screen", _altered_tec),
    ("c5_zp128.bent_screen", _unchanged_ray),
]


FAULTS = [(w, f) for w, f in FAULTS if w in workloads()]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_fault_is_not_correct(cpu_run, monkeypatch, workload, fault):
    fault(monkeypatch)
    code, line, err = cpu_run(workload)
    assert code == 0, err
    assert line["correct"] is False, line["checks"]
