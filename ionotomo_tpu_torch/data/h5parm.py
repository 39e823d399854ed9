"""losoto h5parm interoperability for DataPack (a copy of
``ionotomo_tpu.data.h5parm``).

The LOFAR calibration ecosystem the reference serves (SURVEY.md §0.5)
exchanges direction-dependent solutions as **h5parm** files (losoto's HDF5
layout): a solution set (``sol000``) holding an ``antenna`` table (name +
ITRF position in metres), a ``source`` table (name + [ra, dec] radians) and
solution tables (``tec000``, ``phase000``, …) whose ``val``/``weight``
arrays carry an ``AXES`` attribute naming their dimensions (from
``time, freq, ant, dir, pol``; time in MJD *seconds*, TEC in TECU).

This module reads that layout into a :class:`DataPack` (and writes one back
out), so solutions produced by the standard LOFAR pipelines can be inverted
here directly — the practical replacement for the reference's
``real_data.py`` ingestion path. Reading uses plain h5py: pytables files
are ordinary HDF5 underneath, compound tables included.
"""
from __future__ import annotations

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover - h5py is present in this image
    h5py = None

from .. import constants
from .radio_array import RadioArray


def _decode(x):
    return x.decode() if isinstance(x, bytes) else str(x)


def _soltab_axes(st):
    """Axis-name list of a soltab from val.attrs['AXES'] (fallback: the
    conventional order restricted to the axis datasets present)."""
    axes = st["val"].attrs.get("AXES")
    if axes is not None:
        return [a for a in _decode(axes).split(",") if a]
    return [a for a in ("time", "freq", "ant", "dir", "pol") if a in st]


def _pick_soltab(solset, kind):
    for name, item in solset.items():
        if name.startswith(kind) and isinstance(item, h5py.Group):
            return name
    raise KeyError(f"no '{kind}*' soltab in solution set "
                   f"(have: {list(solset.keys())})")


def load_h5parm(path, solset="sol000", soltab=None, ref_antenna=0,
                noise_tecu=None, frame_model="iau2006"):
    """Read a losoto-layout h5parm into a DataPack.

    ``soltab`` defaults to the first ``tec*`` table; a ``phase*`` table is
    also accepted (converted through the dispersive 1/f law — broadband
    fit across its freq axis when present). Values are re-referenced to
    ``ref_antenna`` (h5parm TEC solutions are per-antenna; dTEC is what
    the tomography consumes). ``weight == 0`` samples become flags.
    ``noise_tecu``: per-sample noise (scalar, TECU); default 1e-3.
    """
    if h5py is None:
        raise RuntimeError("h5py unavailable")
    from .datapack import DataPack

    with h5py.File(path, "r") as f:
        ss = f[solset]
        ant_tab = ss["antenna"][:]
        ant_names = [_decode(n) for n in ant_tab["name"]]
        itrs_km = np.asarray(ant_tab["position"], np.float64) / 1.0e3
        src_tab = ss["source"][:]
        src_radec = {_decode(r["name"]): np.asarray(r["dir"], np.float64)
                     for r in src_tab}

        if soltab is None:
            try:
                soltab = _pick_soltab(ss, "tec")
            except KeyError:
                soltab = _pick_soltab(ss, "phase")
        st = ss[soltab]
        kind = _decode(st.attrs.get("TITLE", soltab.rstrip("0123456789")))
        axes = _soltab_axes(st)
        val = np.asarray(st["val"])
        weight = (np.asarray(st["weight"]) if "weight" in st
                  else np.ones_like(val))
        for need in ("time", "ant", "dir"):
            if need not in axes:
                raise ValueError(f"soltab '{soltab}' lacks a '{need}' axis "
                                 f"(AXES={axes})")

        # reorder to (freq?, ant, time, dir), reducing pol first
        if "pol" in axes:
            val = val.mean(axis=axes.index("pol"))
            weight = weight.min(axis=axes.index("pol"))
            axes = [a for a in axes if a != "pol"]
        order = [a for a in ("freq", "ant", "time", "dir") if a in axes]
        perm = [axes.index(a) for a in order]
        val = np.transpose(val, perm)
        weight = np.transpose(weight, perm)
        freqs = np.asarray(st["freq"]) if "freq" in axes else None

        times_mjd = np.asarray(st["time"], np.float64) / 86400.0
        st_ants = [_decode(a) for a in st["ant"][:]]
        st_dirs = [_decode(d) for d in st["dir"][:]]

    # antenna table restricted (and ordered) to the soltab's antenna axis
    idx = [ant_names.index(a) for a in st_ants]
    array = RadioArray(itrs_km[idx], st_ants, name=_decode(solset))
    directions = np.stack([src_radec[d] for d in st_dirs])  # (Nd, 2)

    flags = ~(weight > 0) | ~np.isfinite(val)
    val = np.where(np.isfinite(val), val, 0.0)

    if kind.startswith("tec"):
        if freqs is not None:          # degenerate freq axis on tec tables
            val, flags = val.mean(axis=0), flags.any(axis=0)
        dtec = val * (constants.TECU / constants.TEC_SCALE)
        frequency_hz = constants.DEFAULT_FREQUENCY_HZ
        dtec = dtec - dtec[ref_antenna:ref_antenna + 1]
        # a corrupted reference sample mis-references EVERY antenna for
        # that (time, dir) — propagate its flag to all rows
        flags = flags | flags[ref_antenna:ref_antenna + 1]
        noise = ((noise_tecu if noise_tecu is not None else 1e-3)
                 * constants.TECU / constants.TEC_SCALE)
        dp = DataPack(array, directions, times_mjd, dtec=dtec,
                      flags=flags, noise_std=noise,
                      ref_antenna=ref_antenna, frequency_hz=frequency_hz,
                      frame_model=frame_model)
    elif kind.startswith("phase"):
        if freqs is None:
            raise ValueError("phase soltab needs a freq axis")
        phase = val - val[:, ref_antenna:ref_antenna + 1]
        flags = flags | flags[:, ref_antenna:ref_antenna + 1]
        noise_rad = None
        if noise_tecu is not None:
            # phase = PHASE_COEF * TEC[m^-2] / f: the per-channel phase
            # noise equivalent of noise_tecu at the most dispersive channel
            noise_rad = (noise_tecu * constants.TECU * constants.PHASE_COEF
                         / float(freqs.min()))
        if freqs.size == 1:
            noise = (None if noise_tecu is None else
                     noise_tecu * constants.TECU / constants.TEC_SCALE)
            dp = DataPack.from_phase(array, directions, times_mjd, phase[0],
                                     float(freqs[0]), flags=flags[0],
                                     noise_std=noise,
                                     ref_antenna=ref_antenna,
                                     frame_model=frame_model)
        else:
            dp = DataPack.from_multifrequency_phase(
                array, directions, times_mjd, phase, freqs,
                phase_noise_rad=noise_rad, flags=flags.any(axis=0),
                ref_antenna=ref_antenna, frame_model=frame_model)
    else:
        raise ValueError(f"unsupported soltab kind '{kind}' "
                         "(expected tec* or phase*)")
    return dp


def save_h5parm(dp, path, solset="sol000"):
    """Write a DataPack as a losoto-layout h5parm (``tec000`` soltab,
    values in TECU referenced to ``dp.ref_antenna``, weights 0 on flags).
    Round-trips through :func:`load_h5parm`."""
    if h5py is None:
        raise RuntimeError("h5py unavailable")
    names = np.asarray(dp.array.labels, dtype="S64")
    ant_dtype = np.dtype([("name", "S64"), ("position", np.float64, (3,))])
    ant_tab = np.zeros(len(dp.array), ant_dtype)
    ant_tab["name"] = names
    ant_tab["position"] = dp.array.itrs * 1.0e3       # km → m
    nd = dp.directions.shape[0]
    src_dtype = np.dtype([("name", "S64"), ("dir", np.float64, (2,))])
    src_tab = np.zeros(nd, src_dtype)
    src_names = [f"DIR{j:03d}" for j in range(nd)]
    src_tab["name"] = np.asarray(src_names, dtype="S64")
    src_tab["dir"] = dp.directions

    with h5py.File(path, "w") as f:
        ss = f.create_group(solset)
        ss.create_dataset("antenna", data=ant_tab)
        ss.create_dataset("source", data=src_tab)
        st = ss.create_group("tec000")
        st.attrs["TITLE"] = np.bytes_(b"tec")
        # (time, ant, dir) — the conventional losoto leading-time order
        val = np.transpose(dp.dtec, (1, 0, 2)) * (constants.TEC_SCALE
                                                  / constants.TECU)
        weight = np.transpose(~dp.flags, (1, 0, 2)).astype(np.float64)
        v = st.create_dataset("val", data=val)
        w = st.create_dataset("weight", data=weight)
        v.attrs["AXES"] = np.bytes_(b"time,ant,dir")
        w.attrs["AXES"] = np.bytes_(b"time,ant,dir")
        st.create_dataset("time", data=dp.times * 86400.0)
        st.create_dataset("ant", data=names)
        st.create_dataset("dir", data=np.asarray(src_names, dtype="S64"))
