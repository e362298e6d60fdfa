"""The process group of the PyTorch port (``parallel/distributed.py``), on
the CPU with gloo.

``initialize`` is a no-op for one process and raises on any failure (the
JAX package's logs and carries on); ``local_batch_slice`` is the JAX
package's ``balance211`` split over the processes; two real processes
(``tests/_torch_distributed_worker.py``) each compute their slice of a
small ``ConvOp`` forward, all-gather them and hold the batch bitwise
against the single op.
"""
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from deepfusion_tpu.utils.mathutil import balance211 as jbalance211
from deepfusion_tpu_torch.parallel import distributed

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_distributed_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n", [None, 1])
def test_initialize_is_a_noop_for_one_process(n):
    distributed.initialize(num_processes=n)
    assert not dist.is_initialized()
    assert distributed.local_batch_slice(7) == (0, 7)
    per = torch.cuda.device_count()
    assert distributed.global_devices_mesh_shape() == \
        {"hosts": 1, "devices_per_host": per, "total": per}


@pytest.mark.parametrize("batch", [1, 5, 8, 13])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_local_batch_slice_matches_jax_balance211(monkeypatch, batch, world):
    """The slices of every rank, as the port computes them under a process
    group of `world`, are the JAX package's balance211 split."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    got = []
    for rank in range(world):
        monkeypatch.setattr(dist, "get_rank", lambda rank=rank: rank)
        got.append(distributed.local_batch_slice(batch))
    assert got == [jbalance211(batch, world, r) for r in range(world)]
    assert got[0][0] == 0 and got[-1][1] == batch


def test_initialize_raises_on_an_unreachable_coordinator():
    """Rank 1 of 2 with nobody listening at the coordinator's port: the
    rendezvous times out and raises, and no process group is left."""
    with pytest.raises(Exception) as e:
        distributed.initialize(f"localhost:{free_port()}", num_processes=2,
                               process_id=1, backend="gloo", timeout_s=2)
    assert not isinstance(e.value, AssertionError)
    assert not dist.is_initialized()


def test_initialize_needs_the_coordinator():
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.initialize(num_processes=2, process_id=0,
                               backend="gloo")


def test_two_gloo_processes_gather_the_single_op():
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(r), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} failed:\n{out}"
        assert f"DIST_OK {r} procs=2" in out, out
    assert "slice=0:3" in outs[0] and "slice=3:5" in outs[1]
