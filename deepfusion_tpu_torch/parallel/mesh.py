"""Device meshes: an array of ``torch.device`` of shape (dp, sp, tp).

The PyTorch counterpart of ``deepfusion_tpu/parallel/mesh.py``. The axes:

  dp: data (batch) parallelism
  sp: spatial (H) parallelism, with a halo exchange
  tp: tensor (output-channel) parallelism

A mesh lies in one process, or spans the processes of a
``torch.distributed`` group (``make_mesh`` with the group up): then each
slot also has its process (``ranks``), and the wrappers of ``shard.py``
run, in each process, the shards of its own slots, with the collectives
between slots of different processes going over the group. A mesh whose
slots repeat one device (all ``cuda:0``, or all ``cpu``) runs the same
shards, and so the same kernel modes, one after another: that is how the
tests and ``chip_smoke.py`` check a mesh on one card. Devices repeat only
where the caller passes them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logger import check
from . import distributed

AXES = ("dp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class Line:
    """The slots of a mesh along one axis, the other axes fixed: each
    slot's device and process, this process, and the group of the line's
    processes (None where they are all this one)."""

    devices: tuple
    ranks: tuple
    rank: int
    group: object
    mesh: "Mesh"

    @property
    def mine(self) -> tuple:
        """The indices of this process's slots along the line."""
        return tuple(i for i, r in enumerate(self.ranks) if r == self.rank)


class Mesh:
    """Devices of a (dp, sp, tp) mesh (``devices``, an object array), the
    process of each slot (``ranks``; all this process's on a mesh of one
    process) and the size of each named axis (``shape``, as
    ``jax.sharding.Mesh``). On a mesh that spans processes, the groups of
    every axis line's processes are made here, once, by every process in
    one order (``dist.new_group`` is collective). ``wire_bytes`` adds up
    the bytes this process's collectives move between processes, as the
    ring model counts them (``shard.tp_wire_bytes``)."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, ranks: np.ndarray = None,
                 rank: int = 0):
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))
        self.ranks = np.full(devices.shape, rank) if ranks is None else ranks
        self.rank = rank
        self.wire_bytes = 0
        self._groups = {}
        for ax in range(len(AXES)):
            lines = np.moveaxis(self.ranks, ax, -1).reshape(
                -1, self.ranks.shape[ax])
            for line in lines:
                procs = tuple(sorted({int(r) for r in line}))
                if len(procs) > 1 and procs not in self._groups:
                    self._groups[procs] = dist.new_group(list(procs))

    def device(self, **index) -> torch.device:
        """The device of the slot at the given axis indices (0 on every
        axis not named)."""
        return self.devices[tuple(index.get(a, 0) for a in AXES)]

    def line(self, axis: str, **index) -> Line:
        """The slots along `axis` at the given indices of the other axes
        (0 on every axis not named)."""
        sl = tuple(slice(None) if a == axis else index.get(a, 0)
                   for a in AXES)
        ranks = tuple(int(r) for r in self.ranks[sl])
        procs = tuple(sorted(set(ranks)))
        return Line(tuple(self.devices[sl]), ranks, self.rank,
                    self._groups.get(procs), self)

    def _home(self, rank: int) -> tuple:
        flat = np.flatnonzero(self.ranks.reshape(-1) == rank)
        check(flat.size > 0, f"process {rank} holds no slot of the mesh")
        return tuple(int(i) for i in np.unravel_index(flat[0],
                                                      self.ranks.shape))

    def home(self, *axes: str) -> dict:
        """The indices, on the axes other than `axes`, of this process's
        first slot: a wrapper over `axes` runs the slice of the mesh
        through it (on a mesh of one process, index 0 on every other
        axis). Every process holding a slot of that slice must have its
        first slot there too, so that all of them run it."""
        fixed = {a: i for a, i in zip(AXES, self._home(self.rank))
                 if a not in axes}
        sl = tuple(slice(None) if a in axes else fixed[a] for a in AXES)
        for r in np.unique(self.ranks[sl]):
            h = dict(zip(AXES, self._home(int(r))))
            check(all(h[a] == i for a, i in fixed.items()),
                  f"process {int(r)} holds a slot of the mesh's slice "
                  f"{fixed} over {axes} but its first slot lies elsewhere "
                  f"({h}): each process must run one slice")
        return fixed

    def __repr__(self):
        return (f"Mesh({self.shape}, {self.devices.reshape(-1).tolist()}, "
                f"ranks {self.ranks.reshape(-1).tolist()})")


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, devices=None,
              local_devices=None) -> Mesh:
    """A dp x sp x tp mesh over the first dp*sp*tp slots. With ``devices``,
    those devices, all of this process. Else, with a process group of more
    than one process up, every process's ``local_devices`` (by default
    ``distributed.local_devices()``: its card, or the CPU), rank-major, as
    ``jax.devices()`` orders every process's devices; the processes learn
    each other's devices once, here. Else ``local_devices``, or every CUDA
    device. Raises when there are fewer slots than dp*sp*tp."""
    n = dp * sp * tp
    world, rank = distributed._world()
    if devices is None and world > 1:
        mine = local_devices if local_devices is not None \
            else distributed.local_devices()[1]
        every = [None] * world
        dist.all_gather_object(every, [str(torch.device(d)) for d in mine])
        slots = [(d, r) for r, ds in enumerate(every) for d in ds]
    else:
        if devices is None:
            devices = local_devices if local_devices is not None else [
                torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        slots = [(d, rank) for d in devices]
    if len(slots) < n:
        raise ValueError(f"need {n} devices, have {len(slots)}")
    dev = np.empty(n, dtype=object)
    dev[:] = [torch.device(d) for d, _ in slots[:n]]
    ranks = np.array([r for _, r in slots[:n]]).reshape(dp, sp, tp)
    return Mesh(dev.reshape(dp, sp, tp), ranks, rank)


def factorize_mesh(n: int) -> Tuple[int, int, int]:
    """Pick a (dp, sp, tp) factorization for n devices: prefer giving
    factors to dp (cheapest), then tp, then sp."""
    p2 = n & -n                  # the largest power of two dividing n
    tp = min(p2, 2)
    sp = min(p2 // tp, 2)
    dp = (p2 // (tp * sp)) * (n // p2)
    return dp, sp, tp
