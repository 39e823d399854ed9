"""Keyed random draws of the service and the batch pipeline: each use
seeds one CPU ``torch.Generator`` from (the run's seed, a constant for
the use, a global epoch or timestep index) through numpy's
``SeedSequence``, and the draws move to the device afterwards. A
restarted or chunked run draws the same numbers without storing any
generator state, and a run on the card draws what one on the CPU does.
"""
from __future__ import annotations

import numpy as np
import torch

#: The constants that key the uses that the service and the pipeline
#: share.
DRAW_SPECTRUM = 0x5EC7      # the spectrum diagnostic's start block
DRAW_ENKF_INIT = 0x7FFFFFFF  # the initial ensemble (the reference's slot)
DRAW_ENKF_OBS = 0xE0B5      # the members' perturbed observations
DRAW_ENKF_PROCESS = 0xE9C0  # additive process noise
DRAW_ENKF_ANCHOR = 0xEA2C   # perturbed anchor values


def _generator(seed: int, use: int, index: int) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(use), int(index)]
                                   ).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def normals(seed: int, use: int, index: int, shape) -> torch.Tensor:
    """Standard normals of ``shape`` (float32, on the CPU) keyed by
    (``seed``, ``use``, ``index``): the same numbers on every run and
    every device."""
    return torch.randn(tuple(shape), generator=_generator(seed, use, index),
                       dtype=torch.float32)


def rademacher(seed: int, use: int, index: int, shape) -> torch.Tensor:
    """Random signs ±1 (float32) of ``shape``, keyed as ``normals`` is:
    the Hutchinson and Lanczos probes of model selection and empirical
    Bayes."""
    bits = torch.randint(0, 2, tuple(shape),
                         generator=_generator(seed, use, index))
    return (2 * bits - 1).to(torch.float32)
