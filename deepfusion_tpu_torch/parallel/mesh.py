"""Device meshes: an array of ``torch.device`` of shape (dp, sp, tp).

The PyTorch counterpart of ``deepfusion_tpu/parallel/mesh.py``. The axes:

  dp: data (batch) parallelism
  sp: spatial (H) parallelism, with a halo exchange
  tp: tensor (output-channel) parallelism

The sharded wrappers (``shard.py``) run every shard in one process, each
on the device of its mesh slot. A mesh whose slots repeat one device (all
``cuda:0``, or all ``cpu``) runs the same shards, and so the same kernel
modes, one after another: that is how the tests and ``chip_smoke.py``
check a mesh on one card. Devices repeat only where the caller passes
them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

AXES = ("dp", "sp", "tp")


class Mesh:
    """Devices of a (dp, sp, tp) mesh (``devices``, an object array) and
    the size of each named axis (``shape``, as ``jax.sharding.Mesh``)."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    def device(self, **index) -> torch.device:
        """The device of the slot at the given axis indices (0 on every
        axis not named)."""
        return self.devices[tuple(index.get(a, 0) for a in AXES)]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.devices.reshape(-1).tolist()})"


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, devices=None) -> Mesh:
    """A dp x sp x tp mesh over the first dp*sp*tp of ``devices`` (default:
    every CUDA device). Raises when there are fewer."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = dp * sp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.empty(n, dtype=object)
    dev[:] = devices[:n]
    return Mesh(dev.reshape(dp, sp, tp))


def factorize_mesh(n: int) -> Tuple[int, int, int]:
    """Pick a (dp, sp, tp) factorization for n devices: prefer giving
    factors to dp (cheapest), then tp, then sp."""
    p2 = n & -n                  # the largest power of two dividing n
    tp = min(p2, 2)
    sp = min(p2 // tp, 2)
    dp = (p2 // (tp * sp)) * (n // p2)
    return dp, sp, tp
