"""Atomic checkpoint / resume (a copy of ``ionotomo_tpu.utils.checkpoint``;
SURVEY.md §5.3–5.4).

The reference's recovery story is HDF5 `Solution` saves + restart-from-
latest; here every outer iteration writes an **atomic** npz bundle (write
to temp, fsync, rename) holding the full solver state — model grid(s),
prior, iteration counter, Kalman/Krylov state, RNG key — plus the
EngineConfig JSON, so `resume()` continues bit-identically (fault-injection
tested in tests/test_checkpoint.py).
"""
from __future__ import annotations

import os
import tempfile

import numpy as np


def save_checkpoint(directory, step: int, state: dict, config_json: str = "",
                    name: str = None):
    """Atomically write ``state`` (dict of arrays / scalars) at ``step``.

    ``name`` overrides the default per-step filename with a fixed one
    (e.g. a service's rolling ``state.npz``) — same tmp+fsync+rename
    atomicity either way."""
    os.makedirs(directory, exist_ok=True)
    payload = {k: np.asarray(v) for k, v in state.items()}
    payload["__step__"] = np.asarray(step, np.int64)
    payload["__config__"] = np.frombuffer(
        config_json.encode() or b"\x00", dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(directory,
                             name if name else f"ckpt_{step:08d}.npz")
        os.replace(tmp, final)
        return final
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def checkpoint_paths(directory):
    """All checkpoint paths, oldest → newest."""
    if not os.path.isdir(directory):
        return []
    names = sorted(n for n in os.listdir(directory)
                   if n.startswith("ckpt_") and n.endswith(".npz"))
    return [os.path.join(directory, n) for n in names]


def latest_checkpoint(directory):
    """Path of the highest-step checkpoint, or None."""
    paths = checkpoint_paths(directory)
    return paths[-1] if paths else None


def load_checkpoint(path):
    """Returns (step, state dict, config_json)."""
    with np.load(path) as z:
        state = {k: z[k] for k in z.files
                 if not k.startswith("__")}
        step = int(z["__step__"])
        cfg = bytes(z["__config__"]).rstrip(b"\x00").decode()
    return step, state, cfg


def resume(directory):
    """(step, state, config_json) from the newest *readable* checkpoint,
    or (0, None, "") when starting fresh.

    Atomic writes make corruption unlikely, but a hard kill during a
    filesystem flush can still leave the newest file unreadable; rather
    than crashing the restart, fall back to the previous checkpoint
    (the reference's restart-from-last-save semantics, SURVEY.md §5.3).
    """
    for path in reversed(checkpoint_paths(directory)):
        try:
            return load_checkpoint(path)
        except Exception:
            continue
    return 0, None, ""
