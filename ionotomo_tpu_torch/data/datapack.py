"""DataPack — the observation container (host-side, HDF5; a copy of
``ionotomo_tpu.data.datapack``, the same schema: a file written by either
package is read by the other).

Reference parity (SURVEY.md §2 "DataPack"): an HDF5 container of antennas,
directions (ICRS), times, and dTEC/phase arrays of shape [Na, Nt, Nd], with
reference-antenna handling, flagging and subsetting. The on-disk schema is
reference-compatible in spirit (named HDF5 datasets, self-describing attrs)
but laid out for bulk array reads.

The device never sees this object: ``to_device_arrays`` produces the flat
device-ready arrays (antenna ENU, per-time per-direction ENU unit vectors,
dtec, noise std) consumed by the solvers.
"""
from __future__ import annotations

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover - h5py is present in this image
    h5py = None

from .radio_array import RadioArray
from ..geometry.frames import icrs_to_enu


class DataPack:
    """Observations: dtec[Na, Nt, Nd] + geometry + flags + noise."""

    def __init__(self, array: RadioArray, directions_icrs, times_mjd,
                 dtec=None, flags=None, noise_std=None, ref_antenna=0,
                 frequency_hz=150e6, frame_model="iau2006"):
        self.array = array
        self.directions = np.atleast_2d(np.asarray(directions_icrs,
                                                   np.float64))  # (Nd, 2)
        self.times = np.atleast_1d(np.asarray(times_mjd, np.float64))
        na, nt, nd = len(array), len(self.times), len(self.directions)
        self.dtec = (np.zeros((na, nt, nd)) if dtec is None
                     else np.asarray(dtec, np.float64))
        assert self.dtec.shape == (na, nt, nd), self.dtec.shape
        self.flags = (np.zeros((na, nt, nd), bool) if flags is None
                      else np.asarray(flags, bool))
        self.noise_std = (np.full((na, nt, nd), 1.0) if noise_std is None
                          else np.broadcast_to(
                              np.asarray(noise_std, np.float64),
                              (na, nt, nd)).copy())
        self.ref_antenna = int(ref_antenna)
        self.frequency_hz = float(frequency_hz)
        # which ICRS→ENU chain produced/interprets these observations:
        # "iau2006" (precession+nutation+GAST, default) or "gmst" (bare
        # mean-sidereal legacy). Persisted so reloading a pre-upgrade file
        # keeps its original geometry instead of silently mispointing
        # every ray by ~0.3° (advisor r2).
        assert frame_model in ("iau2006", "gmst"), frame_model
        self.frame_model = frame_model

    @property
    def shape(self):
        return self.dtec.shape

    def phase(self, frequency_hz=None):
        """Dispersive ionospheric phase [rad] of the stored dTEC:
        Δφ = PHASE_COEF · dTEC[m^-2] / f (the reference's dTEC/phase dual
        view of the observations)."""
        from .. import constants
        f = frequency_hz or self.frequency_hz
        return constants.PHASE_COEF * (self.dtec * constants.TEC_SCALE) / f

    @staticmethod
    def phase_to_dtec(phase_rad, frequency_hz):
        """Inverse of ``phase``: differential phase [rad] → dTEC in
        working units. The phase must already be unwrapped (see
        ``unwrap_phase_time``); a wrapped phase aliases TEC by
        f/PHASE_COEF·2π per cycle."""
        from .. import constants
        return (np.asarray(phase_rad, np.float64) * frequency_hz
                / (constants.PHASE_COEF * constants.TEC_SCALE))

    @staticmethod
    def unwrap_phase_time(phase_rad):
        """Unwrap observed phases along the time axis (axis 1 of
        [Na, Nt, Nd]) — valid when the epoch cadence keeps |Δφ| < π
        between samples, the standard calibration regime. Absolute 2π·k
        offsets per (antenna, direction) remain unobservable from phase
        alone (they alias into dTEC); anchor them externally or work at
        time-differenced level."""
        return np.unwrap(np.asarray(phase_rad, np.float64), axis=1)

    @classmethod
    def from_phase(cls, array, directions_icrs, times_mjd, phase_rad,
                   frequency_hz, unwrap=True, **kwargs):
        """Build a DataPack from differential-phase observations (the
        reference ingests phases as readily as dTEC)."""
        phase = np.asarray(phase_rad, np.float64)
        if unwrap:
            phase = cls.unwrap_phase_time(phase)
        dtec = cls.phase_to_dtec(phase, frequency_hz)
        return cls(array, directions_icrs, times_mjd, dtec=dtec,
                   frequency_hz=frequency_hz, **kwargs)

    @classmethod
    def from_multifrequency_phase(cls, array, directions_icrs, times_mjd,
                                  phase_rad, frequencies_hz, unwrap=True,
                                  phase_noise_rad=None, **kwargs):
        """Broadband TEC fitting: build a DataPack from phases observed at
        several frequencies (Nf, Na, Nt, Nd) by weighted least squares of
        the dispersive 1/f law per sample — the standard wide-band
        workflow (phase = PHASE_COEF·dTEC·TEC_SCALE / f, so
        dTEC = Σ_i w_i φ_i/f_i⁻¹... solved as a 1-parameter LS in 1/f).

        With equal per-channel phase noise σ_φ the fit noise is
        σ_dtec = σ_φ·f_eff/(PHASE_COEF·TEC_SCALE), f_eff =
        (Σ f_i⁻²)^{-1/2} — lower than any single channel; if
        ``phase_noise_rad`` is given, ``noise_std`` is set accordingly
        (overriding any noise_std kwarg). The stored ``frequency_hz``
        is the lowest channel (most dispersive; only used for phase
        views). Per-channel unwrap runs along time first.
        """
        phase = np.asarray(phase_rad, np.float64)
        freqs = np.asarray(frequencies_hz, np.float64)
        assert phase.ndim == 4 and phase.shape[0] == freqs.size, (
            "phase must be (Nf, Na, Nt, Nd) matching frequencies_hz")
        if unwrap:
            phase = np.unwrap(phase, axis=2)
        from .. import constants
        c = constants.PHASE_COEF * constants.TEC_SCALE
        x = 1.0 / freqs                                  # (Nf,)
        # LS for phi_i = c·dtec·x_i: dtec = Σ x_i φ_i / (c Σ x_i²)
        dtec = np.einsum("f,fatd->atd", x, phase) / (c * np.sum(x * x))
        if phase_noise_rad is not None:
            f_eff = 1.0 / np.sqrt(np.sum(x * x))
            kwargs["noise_std"] = np.full(
                dtec.shape, float(phase_noise_rad) * f_eff / c)
        return cls(array, directions_icrs, times_mjd, dtec=dtec,
                   frequency_hz=float(freqs.min()), **kwargs)

    @classmethod
    def from_h5parm(cls, path, **kwargs):
        """Read a losoto-layout h5parm solution file (tec*/phase* soltab)
        — the LOFAR ecosystem's interchange format; see data/h5parm.py."""
        from .h5parm import load_h5parm
        return load_h5parm(path, **kwargs)

    def to_h5parm(self, path, solset="sol000"):
        """Write as a losoto-layout h5parm (tec000 soltab, TECU)."""
        from .h5parm import save_h5parm
        save_h5parm(self, path, solset=solset)

    @staticmethod
    def concat_times(datapacks):
        """Concatenate DataPacks along the time axis (the inverse of a
        per-epoch stream: merge epoch files into one batch observation).
        Geometry (antennas, directions, reference antenna, frequency)
        must match; times must be strictly increasing across the pieces.
        """
        dps = list(datapacks)
        assert dps, "need at least one DataPack"
        first = dps[0]
        for dp in dps[1:]:
            assert dp.array.labels == first.array.labels, "antenna mismatch"
            assert np.allclose(dp.array.itrs, first.array.itrs), \
                "antenna position mismatch (labels alone don't identify " \
                "an array)"
            assert np.allclose(dp.directions, first.directions), \
                "direction mismatch"
            assert dp.ref_antenna == first.ref_antenna
            assert dp.frequency_hz == first.frequency_hz
            assert dp.frame_model == first.frame_model
        times = np.concatenate([dp.times for dp in dps])
        assert np.all(np.diff(times) > 0), \
            "times must be strictly increasing across the pieces"
        return DataPack(
            first.array, first.directions, times,
            dtec=np.concatenate([dp.dtec for dp in dps], axis=1),
            flags=np.concatenate([dp.flags for dp in dps], axis=1),
            noise_std=np.concatenate([dp.noise_std for dp in dps], axis=1),
            ref_antenna=first.ref_antenna, frequency_hz=first.frequency_hz,
            frame_model=first.frame_model)

    # --- geometry ----------------------------------------------------------

    def antennas_enu(self):
        """(Na, 3) antenna offsets in the array-centre ENU frame [km]."""
        return self.array.enu

    def directions_enu(self):
        """(Nt, Nd, 3) per-time ENU unit vectors toward each source."""
        ra = self.directions[:, 0][None, :]
        dec = self.directions[:, 1][None, :]
        mjd = self.times[:, None]
        return icrs_to_enu(
            ra, dec, mjd, self.array.enu_frame,
            apply_precession_nutation=(self.frame_model != "gmst"))

    def to_device_arrays(self, dtype=np.float32):
        """Flat arrays for the device: dict of plain numpy (cast to f32)."""
        return dict(
            antennas_enu=self.antennas_enu().astype(dtype),
            directions_enu=self.directions_enu().astype(dtype),
            dtec=self.dtec.astype(dtype),
            noise_std=self.noise_std.astype(dtype),
            flags=self.flags,
            ref_antenna=self.ref_antenna,
            frequency_hz=self.frequency_hz,
        )

    # --- subsetting (reference: antenna/facet selection) -------------------

    def select(self, antennas=None, times=None, directions=None):
        """Subset along any axis.

        If the antenna subset drops the current reference antenna, the
        subset is **re-referenced** to its first antenna: dtec row j0 is
        subtracted from every row (dTEC is differential, so re-referencing
        is exact: T_i − T_j0 = (T_i − T_i0) − (T_j0 − T_i0)). Noise adds in
        quadrature with the new reference's noise (the resulting errors are
        correlated across antennas through the shared j0 term — same caveat
        as any dTEC dataset) and flags OR with the new reference's flags.
        """
        ai = np.arange(self.shape[0]) if antennas is None \
            else np.atleast_1d(antennas)
        ti = np.arange(self.shape[1]) if times is None \
            else np.atleast_1d(times)
        di = np.arange(self.shape[2]) if directions is None \
            else np.atleast_1d(directions)
        dtec = self.dtec[np.ix_(ai, ti, di)]
        flags = self.flags[np.ix_(ai, ti, di)]
        noise = self.noise_std[np.ix_(ai, ti, di)]
        ref = self.ref_antenna
        if antennas is not None:
            where = np.nonzero(ai == ref)[0]
            if len(where):
                ref = int(where[0])
            else:
                ref = 0                      # re-reference to the new row 0
                ref_noise = noise[ref:ref + 1].copy()
                dtec = dtec - dtec[ref:ref + 1]
                noise = np.sqrt(noise**2 + ref_noise**2)
                noise[ref] = ref_noise[0]
                flags = flags | flags[ref:ref + 1]
        return DataPack(self.array.subset(ai), self.directions[di],
                        self.times[ti], dtec, flags, noise,
                        ref_antenna=ref, frequency_hz=self.frequency_hz,
                        frame_model=self.frame_model)

    # --- persistence --------------------------------------------------------

    def save(self, path):
        if h5py is None:
            raise RuntimeError("h5py unavailable")
        with h5py.File(path, "w") as f:
            f.attrs["ref_antenna"] = self.ref_antenna
            f.attrs["frequency_hz"] = self.frequency_hz
            f.attrs["frame_model"] = self.frame_model
            f.attrs["array_name"] = self.array.name
            f.create_dataset("antennas/itrs_km", data=self.array.itrs)
            f.create_dataset(
                "antennas/labels",
                data=np.asarray(self.array.labels, dtype="S"))
            f.create_dataset("directions/radec", data=self.directions)
            f.create_dataset("times/mjd", data=self.times)
            f.create_dataset("dtec", data=self.dtec)
            f.create_dataset("flags", data=self.flags)
            f.create_dataset("noise_std", data=self.noise_std)

    @staticmethod
    def load(path, frame_model=None):
        """Load from HDF5. ``frame_model`` overrides the stored/inferred
        ICRS→ENU chain — use it for files from the brief window where the
        IAU-2006 chain was already the default but the provenance
        attribute did not exist yet (pass "iau2006")."""
        if h5py is None:
            raise RuntimeError("h5py unavailable")
        with h5py.File(path, "r") as f:
            labels = [s.decode() for s in f["antennas/labels"][:]]
            array = RadioArray(f["antennas/itrs_km"][:], labels,
                               name=str(f.attrs.get("array_name", "array")))
            return DataPack(
                array,
                f["directions/radec"][:],
                f["times/mjd"][:],
                f["dtec"][:],
                f["flags"][:],
                f["noise_std"][:],
                ref_antenna=int(f.attrs["ref_antenna"]),
                frequency_hz=float(f.attrs["frequency_hz"]),
                # attribute-less files default to the bare-GMST chain:
                # correct for everything the long-lived round-1 code
                # wrote; files from the short window between the IAU-2006
                # frames upgrade and this attribute need the explicit
                # frame_model="iau2006" override above
                frame_model=(frame_model if frame_model is not None
                             else str(f.attrs.get("frame_model", "gmst"))),
            )
