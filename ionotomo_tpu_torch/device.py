"""The device the port puts state on when the caller names none: the card.

Constructors and converters (``Grid3D.create``, ``convert.*``,
``grid_enclosing_rays``, ...) take ``device=None`` to mean
``DEFAULT_DEVICE``, ``torch.device("cuda")``. There is no fallback: on a
machine without CUDA such a call raises, and a caller who wants the CPU
asks for it (``device="cpu"``), as the CPU tests do. Numpy inputs go to
the device of the state they meet; a tensor keeps its device.
"""
from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = torch.device("cuda")


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the card, which must
    be present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ionotomo_tpu_torch puts state on the card unless a device is "
            "named, and torch.cuda.is_available() is False: pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return DEFAULT_DEVICE


def as_tensor(x, dtype=torch.float32, device=None) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor: a tensor keeps its device, anything
    else (numpy, lists) goes to ``resolve(device)``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=resolve(device))


def host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
