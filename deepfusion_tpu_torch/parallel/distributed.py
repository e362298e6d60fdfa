"""Process group init and host-side batch splitting.

The PyTorch counterpart of ``deepfusion_tpu/parallel/distributed.py``, on
``torch.distributed``. The reference has no distributed layer (its topology
is external CPU pinning); here each process of a job joins one process
group, and ``local_batch_slice`` gives it its share of a global batch
(``balance211``, the reference's work split at process granularity). The
caller names the group: nothing is read from the environment, and a
failed init raises (the JAX package's ``initialize`` logs and carries on).

The ``parallel/shard.py`` wrappers run in one process; collectives between
processes (NCCL across cards) under them are not ported yet.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..utils.logger import info
from ..utils.mathutil import balance211


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, timeout_s=None):
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, rendezvous at ``coordinator_address`` (``host:port``,
    or an init URL such as ``tcp://host:port``); a no-op for one process
    (``num_processes`` None or 1). ``backend``: ``"nccl"`` by default (the
    card), ``"gloo"`` for processes on the CPU. ``timeout_s`` bounds the
    rendezvous and the collectives (torch's default, minutes, when None);
    the JAX package's ``initialize`` has no such argument: it is here so
    that a test of an unreachable coordinator fails in seconds. Raises on
    any failure."""
    if num_processes is None or num_processes <= 1:
        info("single process; no process group")
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize: a group of more than one process needs "
                         "coordinator_address and process_id")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend or "nccl", init_method=url,
                            world_size=num_processes, rank=process_id, **kw)
    info("process group up: rank %d of %d (%s)", dist.get_rank(),
         dist.get_world_size(), dist.get_backend())


def _world() -> tuple:
    """(processes, this process's rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_batch_slice(global_batch: int):
    """This process's [start, end) slice of the global batch: balance211
    over the processes (``util/deepfusion_utils.h:190-208``)."""
    world, rank = _world()
    return balance211(global_batch, world, rank)


def global_devices_mesh_shape() -> dict:
    """Processes, CUDA devices per process (0 without CUDA) and CUDA
    devices in all, as the JAX package's counts its processes and local
    devices."""
    world, _ = _world()
    per = torch.cuda.device_count()
    return {"hosts": world, "devices_per_host": per, "total": world * per}
