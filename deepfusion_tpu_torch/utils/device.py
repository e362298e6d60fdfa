"""The port's device rule: it runs on the card unless the caller asks for
the CPU.

Every op and model constructor, every ``load`` and every functional entry
point takes ``device=None``, which means the current CUDA device. Without
CUDA that raises; ``device="cpu"`` runs the plain PyTorch versions, as the
tests do. Nothing falls back to the CPU on its own.
"""
from __future__ import annotations

import numpy as np
import torch


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or the current CUDA device when it
    is None; raises when it is None and CUDA is not available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: deepfusion_tpu_torch runs on the card "
            "unless asked for the CPU; pass device=\"cpu\" to run the plain "
            "PyTorch versions")
    return torch.device("cuda", torch.cuda.current_device())


def as_tensor(x, device=None) -> torch.Tensor:
    """A functional entry point's input: a tensor stays on its own device;
    anything else (a numpy array) goes to ``default_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=default_device(device))
