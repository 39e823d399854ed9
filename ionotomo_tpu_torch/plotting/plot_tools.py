"""Diagnostics plotting (port of ``ionotomo_tpu.plotting.plot_tools``).

Host-side matplotlib, fed from the port's DataPack, Solution and metrics
JSONL, never from inside the hot path; nothing on the engine's paths
imports this module. Uses the non-interactive Agg backend; every function
returns the Figure (or the animation) and optionally writes a file.
"""
from __future__ import annotations

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ..data.datapack import DataPack  # noqa: E402
from ..inversion.solution import Solution  # noqa: E402


def plot_datapack(datapack: DataPack, time_idx=0, antennas=None, ncols=6,
                  filename=None):
    """Per-antenna scatter of dTEC over directions (the reference's
    plot_datapack view): one panel per antenna, colour = dTEC."""
    ants = (np.arange(datapack.shape[0]) if antennas is None
            else np.atleast_1d(antennas))
    nrows = int(np.ceil(len(ants) / ncols))
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(2.2 * ncols, 2.0 * nrows),
                             squeeze=False)
    d = datapack.dtec[:, time_idx, :]
    vmax = np.abs(d).max() or 1.0
    ra = np.rad2deg(datapack.directions[:, 0])
    dec = np.rad2deg(datapack.directions[:, 1])
    for k, a in enumerate(ants):
        ax = axes[k // ncols][k % ncols]
        sc = ax.scatter(ra, dec, c=d[a], cmap="coolwarm",
                        vmin=-vmax, vmax=vmax, s=18)
        ax.set_title(datapack.array.labels[a], fontsize=7)
        ax.set_xticks([])
        ax.set_yticks([])
    for k in range(len(ants), nrows * ncols):
        axes[k // ncols][k % ncols].axis("off")
    fig.colorbar(sc, ax=axes, shrink=0.6, label="dTEC [working units]")
    if filename:
        fig.savefig(filename, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_model_slices(solution: Solution, time_idx=0, axis=2, n_slices=4,
                      filename=None, truth=None):
    """Slices of n_e through the reconstruction (optionally vs truth)."""
    ne = solution.ne(time_idx)
    rows = 2 if truth is not None else 1
    idxs = np.linspace(0, ne.shape[axis] - 1, n_slices + 2)[1:-1].astype(int)
    fig, axes = plt.subplots(rows, n_slices,
                             figsize=(3.0 * n_slices, 2.8 * rows),
                             squeeze=False)
    for j, s in enumerate(idxs):
        sl = np.take(ne, s, axis=axis)
        im = axes[0][j].imshow(sl.T, origin="lower", cmap="viridis")
        axes[0][j].set_title(f"slice {s}", fontsize=8)
        fig.colorbar(im, ax=axes[0][j], shrink=0.7)
        if truth is not None:
            tl = np.take(truth, s, axis=axis)
            im = axes[1][j].imshow(tl.T, origin="lower", cmap="viridis")
            fig.colorbar(im, ax=axes[1][j], shrink=0.7)
    if filename:
        fig.savefig(filename, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_convergence(metrics_records, filename=None):
    """Residual / timing curves from the JSONL metrics stream."""
    recs = [r for r in metrics_records if "residual" in r]
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.2))
    if recs:
        ts = [r.get("timestep", i) for i, r in enumerate(recs)]
        axes[0].plot(ts, [r["residual"] for r in recs], "o-")
        axes[0].set_xlabel("timestep")
        axes[0].set_ylabel("whitened residual")
        axes[0].set_yscale("log")
        axes[1].plot(ts, [r["seconds"] for r in recs], "o-")
        axes[1].set_xlabel("timestep")
        axes[1].set_ylabel("solve seconds")
    if filename:
        fig.savefig(filename, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig


def animate_model(solution: Solution, axis=2, slice_idx=None, filename=None,
                  fps=5):
    """Time animation of one n_e slice (returns matplotlib animation)."""
    from matplotlib import animation

    ne0 = solution.ne(0)
    s = ne0.shape[axis] // 2 if slice_idx is None else slice_idx
    fig, ax = plt.subplots(figsize=(4, 3.6))
    im = ax.imshow(np.take(ne0, s, axis=axis).T, origin="lower",
                   cmap="viridis")
    fig.colorbar(im, ax=ax, shrink=0.8, label="n_e [m^-3]")

    def update(t):
        im.set_array(np.take(solution.ne(t), s, axis=axis).T)
        ax.set_title(f"t={t}")
        return (im,)

    anim = animation.FuncAnimation(fig, update,
                                   frames=solution.num_times,
                                   blit=False)
    if filename:
        anim.save(filename, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
    return anim


def animate_datapack(datapack: DataPack, antennas=None, ncols=4,
                     filename=None, fps=4):
    """Time animation of the per-antenna dTEC sky scatter (the reference's
    datapack animation view, SURVEY.md §2 plotting row): each frame is
    plot_datapack at one timestep, colour scale fixed across time so
    travelling ionospheric structure reads as motion."""
    from matplotlib import animation

    ants = (np.arange(min(datapack.shape[0], ncols * 2))
            if antennas is None else np.atleast_1d(antennas))
    ncols = min(ncols, len(ants))
    nrows = int(np.ceil(len(ants) / ncols))
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(2.2 * ncols, 2.0 * nrows),
                             squeeze=False)
    vmax = np.abs(datapack.dtec[ants]).max() or 1.0
    ra = np.rad2deg(datapack.directions[:, 0])
    dec = np.rad2deg(datapack.directions[:, 1])
    scatters = []
    for k, a in enumerate(ants):
        ax = axes[k // ncols][k % ncols]
        sc = ax.scatter(ra, dec, c=datapack.dtec[a, 0], cmap="coolwarm",
                        vmin=-vmax, vmax=vmax, s=18)
        ax.set_title(datapack.array.labels[a], fontsize=7)
        ax.set_xticks([])
        ax.set_yticks([])
        scatters.append(sc)
    for k in range(len(ants), nrows * ncols):
        axes[k // ncols][k % ncols].axis("off")
    fig.colorbar(scatters[-1], ax=axes, shrink=0.6,
                 label="dTEC [working units]")

    def update(t):
        for sc, a in zip(scatters, ants):
            sc.set_array(datapack.dtec[a, t])
        fig.suptitle(f"t={t} (mjd {datapack.times[t]:.4f})", fontsize=9)
        return scatters

    anim = animation.FuncAnimation(fig, update, frames=datapack.shape[1],
                                   blit=False)
    if filename:
        anim.save(filename, writer=animation.PillowWriter(fps=fps))
        plt.close(fig)
    return anim


def plot_vtec_map(solution: Solution, time_idx=0, filename=None,
                  anchors_xy=None):
    """Vertical-TEC map of a reconstruction in TECU (the standard science
    product; forward.tec.vtec_map), with physical ENU extent and optional
    anchor pierce-point overlay (inversion/anchors.py geometry)."""
    import torch

    from .. import constants
    from ..device import host
    from ..forward.tec import vtec_map

    g = solution.grid
    v = host(vtec_map(torch.as_tensor(solution.m[time_idx],
                                      device=g.device), g))
    v_tecu = v * constants.TEC_SCALE / constants.TECU
    x0, y0 = float(g.origin[0]), float(g.origin[1])
    x1 = x0 + float(g.spacing[0]) * (g.shape[0] - 1)
    y1 = y0 + float(g.spacing[1]) * (g.shape[1] - 1)
    fig, ax = plt.subplots(figsize=(5.2, 4.4))
    im = ax.imshow(v_tecu.T, origin="lower", extent=(x0, x1, y0, y1),
                   cmap="viridis", aspect="equal")
    fig.colorbar(im, ax=ax, label="VTEC [TECU]")
    if anchors_xy is not None:
        a = np.atleast_2d(np.asarray(anchors_xy))
        ax.scatter(a[:, 0], a[:, 1], marker="x", c="w", s=40,
                   label="anchors")
        ax.legend(loc="upper right", fontsize=8)
    ax.set_xlabel("East [km]")
    ax.set_ylabel("North [km]")
    ax.set_title(f"vertical TEC, t={time_idx}")
    if filename:
        fig.savefig(filename, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig
