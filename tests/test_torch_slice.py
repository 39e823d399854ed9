"""The port's bent-ray serving slice against the JAX package, end to end,
and the port's hygiene: no jax import, state carried across by
``convert``, kernel wrappers that refuse what their kernels do not take,
tables baked into the CUDA sources that equal the port's, and a
``chip_smoke.py`` that stops at once without a card.
"""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ionotomo_tpu.core.grids import Grid3D as JGrid
from ionotomo_tpu.forward import tec as jtec
from ionotomo_tpu.geometry import fermat as jfermat, rays as jrays
from ionotomo_tpu.models import chapman as jchapman
from ionotomo_tpu_torch import convert, kernels
from ionotomo_tpu_torch.core import boxspline as tbox
from ionotomo_tpu_torch.forward import tec as ttec
from ionotomo_tpu_torch.geometry import fermat as tfermat, rays as trays
from ionotomo_tpu_torch.kernels import build

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _slice_epochs(n=16, na=8, nd=4, n_epochs=2):
    """(JAX grid, [(m, antennas, directions)] per epoch), numpy-seeded."""
    jg = JGrid.from_bounds((-400, -400, 0.0), (400, 400, 1100.0), (n, n, n))
    base = np.array(jchapman.log_parametrize(jchapman.chapman_field(jg)))
    pts = jg.meshgrid()
    rng = np.random.default_rng(11)
    ants = np.concatenate([rng.uniform(-150, 150, (na, 2)),
                           np.zeros((na, 1))], -1).astype(np.float32)
    epochs = []
    for _ in range(n_epochs):
        m = base.copy()
        for _ in range(3):
            k = rng.uniform(-1, 1, 3) * 2 * np.pi / np.array([300., 300.,
                                                              500.])
            m += rng.uniform(0.1, 0.3) * np.sin(pts @ k
                                                 + rng.uniform(0, 2 * np.pi))
        zen = rng.uniform(0.05, 0.6, nd)
        az = rng.uniform(0, 2 * np.pi, nd)
        dirs = np.stack([np.sin(zen) * np.sin(az), np.sin(zen) * np.cos(az),
                         np.cos(zen)], -1).astype(np.float32)
        epochs.append((m.astype(np.float32), ants, dirs))
    return jg, epochs


def test_serving_slice_matches_jax():
    """``predict --bent --interp zp --quadrature hermite`` per epoch:
    make_ray_batch → trace_rays(leapfrog@64, keep_path) → dtec_paired_q.
    16³, Na=8, Nd=4, 2 epochs. Tolerance 2e-6·max|TEC| (measured
    ~3e-7): the operator's own bound; the traced paths agree to ~1e-4 km
    and move the dTEC far less than that."""
    jg, epochs = _slice_epochs()
    tg = convert.grid_from_numpy(jg, device="cpu")
    i0 = 1
    for m, ants, dirs in epochs:
        jo, jd = jrays.make_ray_batch(ants, dirs)
        jb, jt = jfermat.trace_rays(jnp.asarray(m), jg, jo, jd, 150e6,
                                    1000.0, n_steps=64, keep_path=True,
                                    method="leapfrog", interp="zp")
        want = np.asarray(jtec.dtec_paired_q(jnp.asarray(m), jg, jb,
                                             len(dirs), i0, "hermite", "zp"))
        tm = convert.field_from_numpy(m, device="cpu")
        to, td = trays.make_ray_batch(torch.from_numpy(ants),
                                      torch.from_numpy(dirs))
        tb, _ = tfermat.trace_rays(tm, tg, to, td, 150e6, 1000.0,
                                   n_steps=64, keep_path=True,
                                   method="leapfrog", interp="zp")
        got = ttec.dtec_paired_q(tm, tg, tb, len(dirs), i0, "hermite",
                                 "zp").numpy()
        assert got.shape == (len(ants), len(dirs))
        assert np.all(np.isfinite(got)) and np.all(got[i0] == 0.0)
        np.testing.assert_allclose(tb.points.numpy(), np.asarray(jb.points),
                                   rtol=0, atol=5e-4)
        scale = np.abs(np.asarray(jt)).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax or jaxlib."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ionotomo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ionotomo_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('ionotomo_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 12


def test_convert_round_trips_grid_and_field():
    jg = JGrid.from_bounds((-400, -300, 0.0), (400, 300, 1100.0),
                           (9, 7, 11))
    m = np.asarray(jchapman.log_parametrize(jchapman.chapman_field(jg)))
    tg = convert.grid_from_numpy(jg, device="cpu")
    tg2 = convert.grid_from_numpy(np.asarray(jg.origin),
                                  np.asarray(jg.spacing), jg.shape,
                                  device="cpu")
    for g in (tg, tg2):
        assert g.shape == jg.shape
        np.testing.assert_array_equal(g.origin.numpy(), np.asarray(jg.origin))
        np.testing.assert_array_equal(g.spacing.numpy(),
                                      np.asarray(jg.spacing))
    back = JGrid.create(tg.origin.numpy(), tg.spacing.numpy(), tg.shape)
    np.testing.assert_array_equal(np.asarray(back.origin),
                                  np.asarray(jg.origin))
    np.testing.assert_array_equal(np.asarray(back.spacing),
                                  np.asarray(jg.spacing))
    tm = convert.field_from_numpy(m, device="cpu")
    assert tm.dtype == torch.float32 and tm.is_contiguous()
    np.testing.assert_array_equal(tm.numpy(), m)
    # the port builds the same grid and Chapman field itself
    from ionotomo_tpu_torch.core.grids import Grid3D
    from ionotomo_tpu_torch.models import chapman as tchapman
    own = Grid3D.from_bounds((-400, -300, 0.0), (400, 300, 1100.0),
                             (9, 7, 11), device="cpu")
    np.testing.assert_array_equal(own.spacing.numpy(),
                                  np.asarray(jg.spacing))
    np.testing.assert_allclose(
        tchapman.log_parametrize(tchapman.chapman_field(own)).numpy(), m,
        rtol=1e-6, atol=1e-5)


def _wrapper_calls():
    """(name, call(**overrides)) for each kernel wrapper with valid CPU
    inputs."""
    g = convert.grid_from_numpy((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (4, 5, 6),
                                device="cpu")
    coef = torch.zeros((20, 6))
    pts = torch.zeros((7, 3))

    def vg(coef2d=coef, points=pts):
        return kernels.zp_value_grad(coef2d, g, points)

    def rv(table=coef, ri=torch.zeros((7, 8), dtype=torch.int32),
           wxy=torch.zeros((7, 8)), zi=torch.zeros((7, 3), dtype=torch.int32),
           wz=torch.zeros((7, 3))):
        return kernels.rows_value_fwd(table, ri, wxy, zi, wz, True)

    def tr(coef2d=coef, origins=pts, directions=pts):
        return kernels.trace_leapfrog_zp(
            coef2d, g, origins, directions, 4, False, h=1.0, hh12=1.0,
            w_n=1.0, w_rhs=1.0, k_ne=1.0, tec_unit=1.0)

    return {"zp_value_grad": (vg, "points", "coef2d"),
            "rows_value_fwd": (rv, "ri", "wxy"),
            "trace_leapfrog_zp": (tr, "origins", "coef2d")}


@pytest.mark.parametrize("name", ["zp_value_grad", "rows_value_fwd",
                                  "trace_leapfrog_zp"])
def test_kernel_wrappers_refuse_bad_inputs(name):
    """Each wrapper raises on a wrong dtype, a wrong shape and a CPU
    tensor (the plain versions take CPU tensors; the kernel entry never
    does) before it builds or launches anything."""
    call, first, other = _wrapper_calls()[name]
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    good = call.__defaults__[list(call.__code__.co_varnames).index(first)]
    with pytest.raises(TypeError, match="float64|torch.int64"):
        call(**{first: good.double() if good.is_floating_point()
                else good.long()})
    with pytest.raises(ValueError, match="shape"):
        call(**{other: torch.zeros((3, 2))})
    with pytest.raises(ValueError, match="contiguous"):
        call(**{first: good.t().contiguous().t()})
    assert kernels.launches == before


def test_rows_value_wrapper_bounds_k_and_l():
    with pytest.raises(ValueError, match="K <= 16"):
        kernels.rows_value_fwd(torch.zeros((4, 6)),
                               torch.zeros((2, 17), dtype=torch.int32),
                               torch.zeros((2, 17)),
                               torch.zeros((2, 3), dtype=torch.int32),
                               torch.zeros((2, 3)), True)


def test_cuda_tables_equal_the_ports_tables():
    """zp_eval.cuh defines the canonical-piece tables once, in ``zp_cw3``,
    ``zp_cu3``, ``zp_cv3`` and ``zp_dxy`` (read as constants of the code by
    ``zp_translate_unrolled``; ``zp_tables`` copies them into the constant
    memory that ``zp_translate`` reads); they must be the port's (and so
    the reference's) tables."""
    src = (build.CSRC / "zp_eval.cuh").read_text()

    def table(fn):
        body = re.search(fn + r"\(int \w+,\s*int k\) \{\s*constexpr \w+ "
                         r"t[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        return np.asarray([float(x.rstrip("f"))
                           for x in re.findall(r"-?\d+(?:\.\d*)?f?", body)],
                          np.float32)

    np.testing.assert_array_equal(table("zp_cw3"), tbox._CW3.ravel())
    np.testing.assert_array_equal(table("zp_cu3"), tbox._CU3.ravel())
    np.testing.assert_array_equal(table("zp_cv3"), tbox._CV3.ravel())
    np.testing.assert_array_equal(table("zp_dxy"),
                                  np.concatenate([tbox._DX3, tbox._DY3]))
    assert not np.any(tbox._CW3[:, 7]) and not np.any(tbox._CU3[:, 7])


def test_build_flags_target_hopper_with_ieee_math():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert {p.name for p in build.sources()} == {
        "trace_leapfrog_zp.cu", "zp_value_grad.cu", "rows_value_fwd.cu",
        "rows_value_bwd.cu", "zp_value_grad_bwd.cu", "vector_gather.cu",
        "cubic_value_grad.cu", "cubic_value_grad_bwd.cu",
        "trace_leapfrog_cubic.cu", "rows_value_fwd_batched.cu",
        "rows_value_bwd_batched.cu", "zpc_value_grad.cu",
        "zpc_value_grad_bwd.cu", "quad_value_grad.cu",
        "trace_leapfrog_zpc.cu", "trace_leapfrog_quad.cu", "trace_split.cu",
        "cubic_sharded.cu", "cubic_sharded_bwd.cu"}
    assert build.BUILD_DIR.relative_to(REPO).parts[0] == "build"


def test_chip_smoke_without_cuda_exits_nonzero_before_building(tmp_path):
    """No card: the script stops at once, prints no result and builds
    nothing. Alone in a directory it cannot run either."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "phase" not in out.stdout
    assert "is_available" in out.stderr
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["chip_smoke.py"]


def test_chip_smoke_takes_a_device_time_only_from_two_agreeing_traces():
    """``chip_smoke.agreed_reading``: a short trace (lost records) reads
    low and must not be taken on its own."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert chip_smoke.agreed_reading([]) is None
    assert chip_smoke.agreed_reading([0.87]) is None
    assert chip_smoke.agreed_reading([0.30, 0.87]) is None
    assert chip_smoke.agreed_reading([0.30, 0.87, 0.88]) == 0.88
    assert chip_smoke.agreed_reading([0.86, 0.87]) == 0.87
    # lost records are made good before two traces are compared: five
    # calls of a fill and a scatter, of which traces kept 3, 2 and 5; 17 of
    # 20 launches of one kernel; a stray first-use copy counts for nothing
    full = {"fill": (5, 100.0), "scatter": (5, 1785.0)}
    traces = [{"fill": (3, 60.0), "scatter": (3, 1071.0)},
              {"fill": (2, 40.0), "scatter": (2, 714.0)}, full]
    np.testing.assert_allclose(chip_smoke.whole_readings(traces, 5),
                               [0.377, 0.377, 0.377], rtol=1e-12)
    np.testing.assert_allclose(
        chip_smoke.whole_readings([{"k3b": (17, 17 * 787.0)},
                                   {"k3b": (20, 20 * 787.0),
                                    "copy": (1, 1300.0)}], 20),
        [0.787, 0.787], rtol=1e-12)
    assert chip_smoke.whole_readings([{}, {"k": (1, 9.0)}], 5) == [None, None]


def test_parent_refuses_a_checkout_of_other_sources():
    """``chip_smoke.Parent`` binds the C interfaces of one commit's
    kernels, declared by the SHA-256 of their sources; a checkout with
    other sources (this one) is refused before anything is built."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    with pytest.raises(ValueError, match="not those of the commit"):
        chip_smoke.Parent(REPO)
