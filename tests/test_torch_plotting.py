"""The port's plots and animations (``plotting.plot_tools``) render from
the port's own objects (its DataPack, Solution and ``tec.vtec_map`` on the
CPU), as ``tests/test_selection_plotting.py:63-158`` renders the
reference's: each writes its file, and the VTEC map's image is the port's
``vtec_map`` in TECU, within 1e-5 relative of the reference's."""
import numpy as np
import jax.numpy as jnp
import torch

from ionotomo_tpu.core.grids import Grid3D as JGrid3D
from ionotomo_tpu.forward.tec import vtec_map as jvtec_map
from ionotomo_tpu_torch import constants
from ionotomo_tpu_torch.core.grids import Grid3D
from ionotomo_tpu_torch.data.synth import generate_example_datapack
from ionotomo_tpu_torch.inversion.solution import Solution
from ionotomo_tpu_torch.models import chapman
from ionotomo_tpu_torch.plotting import plot_tools

torch.set_num_threads(2)


def datapack(n_times=1):
    dp, _ = generate_example_datapack(n_antennas=12, n_directions=6,
                                      n_times=n_times,
                                      grid_shape=(12, 12, 12), n_samples=17,
                                      device="cpu")
    return dp


def chapman_solution(lo, hi, n_times):
    grid = Grid3D.from_bounds(lo, hi, (10, 10, 10), device="cpu")
    m = chapman.log_parametrize(chapman.chapman_field(grid)).numpy()
    return Solution(grid, np.stack([m + 0.01 * t for t in range(n_times)]))


def test_plots_render(tmp_path):
    dp = datapack()
    plot_tools.plot_datapack(dp, filename=str(tmp_path / "dp.png"))
    sol = chapman_solution((0, 0, 0), (100, 100, 100), 2)
    plot_tools.plot_model_slices(sol, filename=str(tmp_path / "sl.png"),
                                 truth=sol.ne(0))
    recs = [dict(timestep=0, residual=10.0, seconds=1.0),
            dict(timestep=1, residual=3.0, seconds=0.8)]
    plot_tools.plot_convergence(recs, filename=str(tmp_path / "cv.png"))
    for name in ("dp", "sl", "cv"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000


def test_animations_write_gifs(tmp_path):
    sol = chapman_solution((-100, -100, 0), (100, 100, 400), 3)
    p1 = tmp_path / "model.gif"
    plot_tools.animate_model(sol, filename=str(p1), fps=2)
    assert p1.exists() and p1.stat().st_size > 200
    p2 = tmp_path / "dp.gif"
    plot_tools.animate_datapack(datapack(n_times=2), filename=str(p2), fps=2)
    assert p2.exists() and p2.stat().st_size > 200


def test_plot_vtec_map(tmp_path):
    grid = Grid3D.from_bounds((-100, -100, 0), (100, 100, 800), (12, 12, 12),
                              device="cpu")
    m = chapman.log_parametrize(chapman.chapman_field(grid)).numpy()
    sol = Solution(grid, m[None])
    p = tmp_path / "vtec.png"
    fig = plot_tools.plot_vtec_map(sol, filename=str(p),
                                   anchors_xy=[[-50, -50], [50, 50]])
    assert p.exists() and p.stat().st_size > 5000
    image = np.asarray(fig.axes[0].images[0].get_array())
    jgrid = JGrid3D.from_bounds((-100, -100, 0), (100, 100, 800),
                                (12, 12, 12))
    want = np.asarray(jvtec_map(jnp.asarray(m), jgrid)).T \
        * constants.TEC_SCALE / constants.TECU
    np.testing.assert_allclose(image, want, rtol=1e-5)
