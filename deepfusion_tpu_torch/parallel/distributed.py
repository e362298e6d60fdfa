"""Process group init and host-side batch splitting.

The PyTorch counterpart of ``deepfusion_tpu/parallel/distributed.py``, on
``torch.distributed``. The reference has no distributed layer (its topology
is external CPU pinning); here each process of a job joins one process
group, and ``local_batch_slice`` gives it its share of a global batch
(``balance211``, the reference's work split at process granularity). A
failed init raises (the JAX package's ``initialize`` logs and carries on).

With a group up, ``mesh.make_mesh`` spans every process's devices
(``local_devices``), and the ``parallel/shard.py`` wrappers run each
process's own shards, their collectives between processes going over the
group (NCCL between cards, or gloo).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..utils.logger import info
from ..utils.mathutil import balance211


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, timeout_s=None):
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, rendezvous at ``coordinator_address`` (``host:port``,
    or an init URL such as ``tcp://host:port``); a no-op for one process
    (``num_processes`` 1). With no arguments, the group that ``torchrun``
    describes in the environment (``env://``: ``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) where ``WORLD_SIZE`` > 1, as the JAX
    package's ``initialize()`` detects its TPU job; else a no-op.
    ``backend``: when None, ``"nccl"`` where CUDA is available (the card),
    else ``"gloo"``. For an NCCL group this process's CUDA device
    (``local_devices``) is made current first. ``timeout_s`` bounds the
    rendezvous and the collectives (torch's default, minutes, when None);
    the JAX package's ``initialize`` has no such argument: it is here so
    that a test of an unreachable coordinator fails in seconds. Raises on
    any failure."""
    args = (coordinator_address, num_processes, process_id)
    from_env = all(a is None for a in args)
    if (num_processes is not None and num_processes <= 1) or (
            from_env and int(os.environ.get("WORLD_SIZE", "1")) <= 1):
        info("single process; no process group")
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    if from_env:
        kw["init_method"] = "env://"
        rank = int(os.environ["RANK"])
    else:
        if None in args:
            raise ValueError("initialize: a group of more than one process "
                             "needs coordinator_address, num_processes and "
                             "process_id")
        url = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        kw.update(init_method=url, world_size=num_processes, rank=process_id)
        rank = process_id
    if backend == "nccl":
        torch.cuda.set_device(_cuda_device(rank))
    dist.init_process_group(backend, **kw)
    info("process group up: rank %d of %d (%s)", dist.get_rank(),
         dist.get_world_size(), dist.get_backend())


def _world() -> tuple:
    """(processes, this process's rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _cuda_device(rank: int) -> torch.device:
    """The card of the process of this rank: ``LOCAL_RANK`` (torchrun's
    index of the process on its host), else the rank, modulo the cards."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def local_devices() -> tuple:
    """(this process's rank, its devices in a mesh that spans the group):
    its card (``LOCAL_RANK`` or the rank, modulo the cards), or the CPU
    where CUDA is not available."""
    _, rank = _world()
    if torch.cuda.is_available():
        return rank, [_cuda_device(rank)]
    return rank, [torch.device("cpu")]


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
