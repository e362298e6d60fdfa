"""One process of the two-process test in test_torch_distributed.py.

Joins a gloo process group on localhost (``parallel.distributed.initialize``),
computes its ``local_batch_slice`` of a small ConvOp forward on the CPU,
all-gathers the slices and, on every rank, checks the joined batch against
the single op's forward of the whole batch, bitwise. Imports no JAX.

    python tests/_torch_distributed_worker.py PORT RANK WORLD
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def main():
    port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    from deepfusion_tpu_torch.config import ConvConfig
    from deepfusion_tpu_torch.ops.conv import ConvOp
    from deepfusion_tpu_torch.parallel import distributed
    from deepfusion_tpu_torch.utils.mathutil import balance211

    distributed.initialize(f"localhost:{port}", num_processes=world,
                           process_id=rank, backend="gloo", timeout_s=60)
    assert dist.get_world_size() == world and dist.get_rank() == rank
    per = torch.cuda.device_count()
    shape = distributed.global_devices_mesh_shape()
    assert shape == {"hosts": world, "devices_per_host": per,
                     "total": world * per}

    rng = np.random.default_rng(7)
    bs, hw, ic, oc = 5, 9, 32, 32
    src = rng.integers(0, 256, (bs, hw, hw, ic), dtype=np.uint8)
    wei = rng.integers(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-100, 101, (oc,)).astype(np.int32)
    cfg = ConvConfig.make((bs, hw, hw, ic), (oc, ic, 3, 3), bia.dtype,
                          (1, 1), (1, 1), (bs, hw, hw, oc), "u8",
                          conv0_relu=True, conv0_scales=(0.02,))
    op = ConvOp(cfg, wei, bia, device="cpu")
    lo, hi = distributed.local_batch_slice(bs)
    with torch.inference_mode():
        mine = op(torch.from_numpy(src[lo:hi]))
        whole = op(torch.from_numpy(src))
    # balance211 slices differ in size: gather them padded to the largest
    sizes = [e - s for s, e in (balance211(bs, world, r)
                                for r in range(world))]
    pad = torch.zeros((max(sizes),) + tuple(mine.shape[1:]),
                      dtype=mine.dtype)
    pad[:mine.shape[0]] = mine
    parts = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(parts, pad)
    got = torch.cat([p[:n] for p, n in zip(parts, sizes)])
    assert torch.equal(got, whole), "gathered slices differ from the op"
    print(f"DIST_OK {rank} procs={world} slice={lo}:{hi}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
