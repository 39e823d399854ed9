"""Antenna & facet (direction) selection (a copy of
``ionotomo_tpu.data.selection``: numpy, bitwise the reference; reference:
astro/antenna_facet_selection.py, SURVEY.md §2).

Host-side helpers that pick informative subsets of a DataPack: core vs
remote stations, greedy max-spread facets, flag-aware pruning, and the
automatic flagging of impulsive outliers.
"""
from __future__ import annotations

import numpy as np

from .datapack import DataPack


def core_antenna_indices(datapack: DataPack, radius_km=5.0):
    """Antennas within ``radius_km`` of the array centre (ENU)."""
    r = np.linalg.norm(datapack.array.enu[:, :2], axis=1)
    return np.nonzero(r <= radius_km)[0]


def remote_antenna_indices(datapack: DataPack, radius_km=5.0):
    r = np.linalg.norm(datapack.array.enu[:, :2], axis=1)
    return np.nonzero(r > radius_km)[0]


def select_antennas_by_distance(datapack: DataPack, n: int,
                                include_ref=True):
    """n antennas spread over baseline lengths (log-spaced), always keeping
    the reference antenna when ``include_ref``."""
    r = np.linalg.norm(datapack.array.enu[:, :2], axis=1)
    order = np.argsort(r)
    n = min(n, len(order))
    # log-spread slots, deduplicated by advancing to the next unused slot so
    # exactly n distinct antennas come back even when n ~ Na
    slots = np.round(np.linspace(0, len(order) - 1, n)).astype(int)
    used = np.zeros(len(order), bool)
    pos = []
    for s in slots:
        while s < len(order) and used[s]:
            s += 1
        if s >= len(order):                     # wrapped: take any free slot
            s = int(np.nonzero(~used)[0][0])
        used[s] = True
        pos.append(s)
    pos = np.asarray(pos)
    picks = order[pos]
    if include_ref and datapack.ref_antenna not in picks:
        # replace the pick nearest (in baseline-length rank) to the ref, so
        # the spread — including the longest baseline — is preserved
        ref_rank = int(np.nonzero(order == datapack.ref_antenna)[0][0])
        picks[np.argmin(np.abs(pos - ref_rank))] = datapack.ref_antenna
    return datapack.select(antennas=np.sort(picks))


def select_facets_max_spread(datapack: DataPack, n: int):
    """Greedy farthest-point selection of n directions on the sky — the
    facet-spread heuristic: start from the direction closest to the field
    centre, then repeatedly add the direction farthest from the chosen set."""
    radec = datapack.directions
    # gnomonic-ish local coords for small fields
    ra0, dec0 = radec[:, 0].mean(), radec[:, 1].mean()
    x = (radec[:, 0] - ra0) * np.cos(dec0)
    y = radec[:, 1] - dec0
    pts = np.stack([x, y], -1)
    first = int(np.argmin(np.linalg.norm(pts, axis=1)))
    chosen = [first]
    while len(chosen) < min(n, len(pts)):
        d = np.min(np.linalg.norm(pts[:, None, :] - pts[None, chosen, :],
                                  axis=-1), axis=1)
        d[chosen] = -1.0
        chosen.append(int(np.argmax(d)))
    return datapack.select(directions=np.sort(chosen))


def drop_flagged(datapack: DataPack, max_flag_fraction=0.5):
    """Remove antennas whose flagged fraction exceeds the threshold (the
    reference antenna is never dropped)."""
    frac = datapack.flags.mean(axis=(1, 2))
    keep = np.nonzero(frac <= max_flag_fraction)[0]
    if datapack.ref_antenna not in keep:
        keep = np.sort(np.concatenate([[datapack.ref_antenna], keep]))
    return datapack.select(antennas=keep)


def flag_outliers(datapack: DataPack, threshold: float = 6.0,
                  min_epochs: int = 4):
    """Automatic outlier flagging: detect **impulsive** (single-epoch)
    spikes — RFI hits, glitches — in each (antenna, direction) series.

    Statistic: a sample's minimum distance to its time neighbours — a
    spike differs from BOTH neighbours, while the neighbour of a spike
    still matches its other side, so single spikes don't contaminate
    adjacent epochs (endpoints use their one neighbour). Samples whose
    distance exceeds ``threshold`` × the series' median epoch-to-epoch
    step (floored by the measurement noise) are flagged. The ionosphere
    moves smoothly at calibration cadence, so the median step captures
    signal drift + noise; instrumental spikes sit far outside it. Series
    shorter than ``min_epochs`` are left untouched.

    Deliberately NOT detected: *persistent* level shifts (cycle slips,
    multi-epoch RFI bursts) — by construction both sides of a sustained
    jump match one neighbour. Cycle slips belong to the phase domain:
    ingest via ``DataPack.from_phase`` (whose time unwrap absorbs 2π
    slips) or solve with ``robust_gn``, which down-weights sustained
    misfits the prior cannot explain.

    Returns the number of newly flagged samples; flags are OR'd into
    ``datapack.flags`` in place (the solvers' noise inflation removes
    their weight — or use a ``robust_gn`` solve to down-weight without
    hard flags).
    """
    d = np.asarray(datapack.dtec, np.float64)        # (Na, Nt, Nd)
    na, nt, nd = d.shape
    if nt < min_epochs:
        return 0
    step = np.abs(d[:, 1:, :] - d[:, :-1, :])        # (Na, Nt-1, Nd)
    r = np.empty_like(d)
    r[:, 0] = step[:, 0]
    r[:, -1] = step[:, -1]
    r[:, 1:-1] = np.minimum(step[:, :-1], step[:, 1:])
    scale = np.maximum(np.median(step, axis=1, keepdims=True),
                       datapack.noise_std)
    new = (r > threshold * scale) & ~datapack.flags
    datapack.flags |= new
    return int(new.sum())
