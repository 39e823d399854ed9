"""Radio array: antenna labels + ITRS positions + local ENU frame (a copy of
``ionotomo_tpu.data.radio_array``: numpy, bitwise the reference).

Mirrors the reference's ``RadioArray`` (SURVEY.md §2 "Radio array": antenna
positions/labels from array config files, ITRS coords, array centre) with a
pure-numpy implementation. Configs are plain-text files with
``label x_km y_km z_km`` columns (ITRS/ECEF, km); a deterministic LOFAR-like
layout generator replaces the reference's bundled LOFAR HBA config (which
cannot be copied — the mount is empty and copying is prohibited anyway).
"""
from __future__ import annotations

import io
import os

import numpy as np

from ..geometry.frames import ENUFrame, geodetic_to_ecef

# LOFAR core (Exloo, NL), the canonical array location for this domain.
LOFAR_CORE_LAT = np.deg2rad(52.905)
LOFAR_CORE_LON = np.deg2rad(6.868)


class RadioArray:
    """Antenna set with ITRS positions (km), labels, and an ENU frame."""

    def __init__(self, itrs_km, labels=None, name="array"):
        self.itrs = np.atleast_2d(np.asarray(itrs_km, np.float64))
        n = self.itrs.shape[0]
        self.labels = (list(labels) if labels is not None
                       else [f"ANT{i:03d}" for i in range(n)])
        assert len(self.labels) == n
        self.name = name
        self.center = self.itrs.mean(axis=0)
        self.enu_frame = ENUFrame(self.center)
        self.enu = self.enu_frame.from_ecef(self.itrs)  # (Na, 3) km

    def __len__(self):
        return self.itrs.shape[0]

    def subset(self, indices):
        return RadioArray(self.itrs[indices],
                          [self.labels[i] for i in np.atleast_1d(indices)],
                          name=self.name)

    # --- config-file I/O (reference-style `arrays/` dir) ------------------

    def save_config(self, path):
        with open(path, "w") as f:
            f.write(f"# {self.name}: label x_km y_km z_km (ITRS)\n")
            for lab, p in zip(self.labels, self.itrs):
                f.write(f"{lab} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f}\n")

    @staticmethod
    def load_config(path_or_text, name=None):
        if os.path.exists(str(path_or_text)):
            text = open(path_or_text).read()
            name = name or os.path.splitext(os.path.basename(path_or_text))[0]
        else:
            text = path_or_text
            name = name or "array"
        labels, pos = [], []
        for line in io.StringIO(text):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(parts[0])
            pos.append([float(v) for v in parts[1:4]])
        return RadioArray(np.asarray(pos), labels, name=name)


def generate_lofar_like_array(n_core=24, n_remote=38, seed=0,
                              core_radius_km=2.0, remote_max_km=80.0):
    """Deterministic LOFAR-HBA-like layout: dense core + log-spiral remotes.

    Default 24+38=62 stations, matching the judged config-2 station count
    (BASELINE.json: "62 stations × 100 directions").
    """
    rng = np.random.default_rng(seed)
    # Core: gaussian cluster ~ core_radius.
    core_en = rng.normal(scale=core_radius_km / 2.0, size=(n_core, 2))
    # Remotes: three log-spiral arms.
    if n_remote > 0:
        idx = np.arange(n_remote)
        arm = idx % 3
        t = (idx // 3 + 1).astype(np.float64)
        r = remote_max_km ** (t / t.max())  # log-spaced radii from 1..max
        r = np.clip(r, 3.0, remote_max_km)
        theta = arm * (2 * np.pi / 3) + 0.55 * np.log(r) * 2.0 \
            + rng.normal(scale=0.05, size=n_remote)
        remote_en = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=-1)
    else:
        remote_en = np.zeros((0, 2))
    en = np.concatenate([core_en, remote_en], axis=0)
    labels = ([f"CS{i:03d}HBA" for i in range(n_core)]
              + [f"RS{i:03d}HBA" for i in range(n_remote)])

    center = geodetic_to_ecef(LOFAR_CORE_LAT, LOFAR_CORE_LON, 0.0)
    frame = ENUFrame(center)
    enu = np.concatenate([en, np.zeros((len(en), 1))], axis=-1)
    itrs = frame.to_ecef(enu)
    return RadioArray(itrs, labels, name="lofar_like_hba")
