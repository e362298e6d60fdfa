"""One process of the multi-process tests in test_torch_multiprocess.py.

Joins a gloo process group on localhost, through the environment as
``torchrun`` sets it (``initialize()`` with no arguments) or through
``initialize(address, world, rank)``, builds meshes that span the group's
processes with SLOTS CPU slots per process, and runs every ``parallel``
wrapper of the port at a small size: each process passes its part of the
global input (the block of its slots) and writes its part of the output,
with the block, to OUT (an .npz). It also runs each collective on int32 and
uint8 parts, records a mesh's slots and refuses a pair shard shallower
than its halo. The test holds what it wrote against the JAX package and
the port's single-device op. Imports no JAX; the recipes below are plain
numpy, so that the test builds the same ops in both packages.

    WORLD_SIZE=2 RANK=r LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/_torch_multiprocess_worker.py OUT SLOTS
    python tests/_torch_multiprocess_worker.py OUT SLOTS PORT RANK WORLD
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# FusionNet at the JAX tests' small widths, one image per slot of dp=4
SMALL_NET = dict(batch=4, hw=8, in_ch=16, width=32, num_classes=16)
# three_stage_plan at tests/test_torch_parallel.py's size
PLAN = dict(mb=4, hw=16, ic=16, oc=32, oc1=32, seed=7)

# (label, recipe, wrapper, mesh shape) per world: "A", two processes of one
# slot each; "B", two processes of two slots each, so that local and remote
# slots mix on one axis
RUNS = {
    "A": [
        ("dp_shard ConvOp dp=2", "conv", "dp", (2, 1, 1)),
        ("dp_shard FusionNet dp=2", "fusionnet", "dp", (2, 1, 1)),
        ("sp_conv sum sp=2", "conv_sum", "sp", (1, 2, 1)),
        ("sp_packed PackedConvOp sp=2", "packed", "sp", (1, 2, 1)),
        ("sp_packed PackedConvPairOp pool2 sp=2", "pair", "sp", (1, 2, 1)),
        ("tp_fused_conv psum tp=2", "tp_conv", "tp psum", (1, 1, 2)),
        ("tp_fused_conv reduce_scatter tp=2", "tp_conv",
         "tp reduce_scatter", (1, 1, 2)),
        ("tp_packed_fused psum tp=2", "tp_packed", "tp psum", (1, 1, 2)),
        ("tp_packed_fused reduce_scatter tp=2", "tp_packed",
         "tp reduce_scatter", (1, 1, 2)),
        ("three_stage_plan (2, 1, 1)", "plan", "plan", (2, 1, 1)),
        ("three_stage_plan (1, 2, 1)", "plan", "plan", (1, 2, 1)),
        ("three_stage_plan (1, 1, 2)", "plan", "plan", (1, 1, 2)),
    ],
    "B": [
        ("dp_shard ConvOp dp=4", "conv", "dp", (4, 1, 1)),
        ("dp_shard FusionNet dp=4", "fusionnet", "dp", (4, 1, 1)),
        ("sp_conv sum sp=4", "conv_sum", "sp", (1, 4, 1)),
        ("sp_conv sum dp=2 x sp=2", "conv_sum", "sp dp", (2, 2, 1)),
        ("sp_packed PackedConvOp sp=4", "packed", "sp", (1, 4, 1)),
        ("sp_packed PackedConvOp dp=2 x sp=2", "packed", "sp dp",
         (2, 2, 1)),
        ("sp_packed PackedConvPairOp pool2 sp=4", "pair", "sp", (1, 4, 1)),
        ("tp_fused_conv psum tp=4", "tp_conv", "tp psum", (1, 1, 4)),
        ("tp_fused_conv reduce_scatter tp=4", "tp_conv",
         "tp reduce_scatter", (1, 1, 4)),
        ("tp_packed_fused psum tp=4", "tp_packed", "tp psum", (1, 1, 4)),
        ("tp_packed_fused reduce_scatter tp=4", "tp_packed",
         "tp reduce_scatter", (1, 1, 4)),
        ("three_stage_plan (1, 2, 2)", "plan", "plan", (1, 2, 2)),
        ("three_stage_plan (2, 2, 1)", "plan", "plan", (2, 2, 1)),
        ("three_stage_plan (1, 1, 4)", "plan", "plan", (1, 1, 4)),
        ("three_stage_plan (1, 4, 1)", "plan", "plan", (1, 4, 1)),
    ],
}
COLLECTIVES = ("psum", "psum_scatter", "all_gather", "ppermute")


def edge_u8(rng, shape):
    """Full-range u8 with both saturation edges present."""
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    x.reshape(-1)[:4] = [0, 255, 255, 0]
    return x


def fused_recipe(mb=4, hw=12, ic=16, oc=32, oc1=16, seed=0, with_sum=False):
    """A fused conv3x3+1x1 with a u8 output, SAME padding, at
    tests/test_torch_parallel.py's geometry: {"args", "kw", "weights",
    "inputs"} for ``ConvConfig.make`` and ``ConvOp`` of either package."""
    rng = np.random.default_rng(seed)
    src = edge_u8(rng, (mb, hw, hw, ic))
    wei = rng.integers(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-20000, 20000, (oc,)).astype(np.int32)
    wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
    bia1 = rng.integers(-20000, 20000, (oc1,)).astype(np.int32)
    args = ((mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (1, 1), (1, 1),
            (mb, hw, hw, oc1), "u8")
    kw = dict(conv0_scales=(rng.uniform(0.5, 1.5, oc) / (9 * ic * 40)
                            ).astype(np.float32),
              wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=bia1.dtype,
              conv1_relu=True, conv1_scales=(0.4 / (oc * 40),))
    inputs = [src]
    if with_sum:
        kw.update(sum_dt="u8", sum_scale=0.5)
        inputs.append(edge_u8(rng, (mb, hw, hw, oc1)))
    return dict(args=args, kw=kw, weights=(wei, bia, wei1, bia1),
                inputs=inputs)


def packed_cfg(mb, hw, ic, oc, oc1=None, seed=0):
    """(args, kw, weights) of a packed conv3x3 (fused with a 1x1 where oc1
    is given), per-oc scales: tests/test_torch_packed.py's ``_cfgs``."""
    rng = np.random.default_rng(seed)
    wei = rng.integers(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-20000, 20000, (oc,)).astype(np.int32)
    sc = 1.0 / (9 * ic * 40)
    kw = dict(conv0_relu=True, conv0_scales=(
        rng.uniform(0.5, 1.5, oc) * sc).astype(np.float32),
        conv0_round="nearest")
    wei1 = bia1 = None
    if oc1 is not None:
        wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
        bia1 = rng.integers(-20000, 20000, (oc1,)).astype(np.int32)
        kw.update(wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=bia1.dtype,
                  conv1_relu=True, conv1_round="nearest",
                  conv1_scales=(rng.uniform(0.5, 1.5, oc1) / (oc * 40)
                                ).astype(np.float32))
    args = ((mb, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (1, 1), (1, 1),
            (mb, hw, hw, oc1 or oc), "u8")
    return args, kw, (wei, bia, wei1, bia1)


def recipe(name):
    """The op and the global inputs of each recipe, as numpy data."""
    rng = np.random.default_rng(100)
    if name == "conv":
        return fused_recipe(seed=1)
    if name == "conv_sum":
        return fused_recipe(hw=16, seed=2, with_sum=True)
    if name == "tp_conv":
        return fused_recipe(oc=64, seed=3)
    if name == "fusionnet":
        return dict(inputs=[rng.integers(0, 256, (4, 8, 8, 16),
                                         dtype=np.uint8)])
    if name == "plan":
        return dict(inputs=[np.random.default_rng(1234).integers(
            0, 17, (PLAN["mb"], PLAN["hw"], PLAN["hw"], PLAN["ic"])
        ).astype(np.uint8)])
    if name == "packed":
        args, kw, w = packed_cfg(2, 16, 32, 32, oc1=32, seed=4)
        return dict(args=args, kw=kw, weights=w,
                    spec=dict(h=16, w=16, c=32, halo=1, col_off=2),
                    op_kw=dict(halo_out=1, col_off_out=2),
                    inputs=[edge_u8(rng, (2, 16, 16, 32))])
    if name == "tp_packed":
        args, kw, w = packed_cfg(2, 10, 32, 64, oc1=40, seed=5)
        return dict(args=args, kw=kw, weights=w,
                    spec=dict(h=10, w=10, c=32, halo=2, col_off=2, iwp=16),
                    op_kw=dict(halo_out=1, col_off_out=2),
                    inputs=[edge_u8(rng, (2, 10, 10, 32))])
    if name in ("pair", "shallow_pair"):
        hw, halo, pool2 = (16, 4, True) if name == "pair" else (4, 3, False)
        return dict(a=packed_cfg(2, hw, 32, 64, seed=6),
                    b=packed_cfg(2, hw, 64, 32, seed=7),
                    spec=dict(h=hw, w=hw, c=32, halo=halo, col_off=2,
                              iwp=32),
                    op_kw=dict(halo_out=2 if pool2 else 1, col_off_out=2,
                               pool2=pool2),
                    inputs=[edge_u8(rng, (2, hw, hw, 32))])
    raise KeyError(name)


def port_op(name, device="cpu"):
    """The port's op (or model) of a recipe, on `device`."""
    from deepfusion_tpu_torch.config import ConvConfig
    from deepfusion_tpu_torch.models import FusionNet, FusionNetConfig
    from deepfusion_tpu_torch.ops.conv import ConvOp
    from deepfusion_tpu_torch.ops.mega import PackedConvPairOp
    from deepfusion_tpu_torch.ops.packed import PackedConvOp, PackedSpec
    r = recipe(name)
    if name == "fusionnet":
        return FusionNet(FusionNetConfig(**SMALL_NET), device=device)
    if "spec" not in r:
        return ConvOp(ConvConfig.make(*r["args"], **r["kw"]), *r["weights"],
                      device=device)
    sin = PackedSpec.make(**r["spec"])
    if "a" in r:
        (aa, ak, aw), (ba, bk, bw) = r["a"], r["b"]
        return PackedConvPairOp(ConvConfig.make(*aa, **ak), aw[:2],
                                ConvConfig.make(*ba, **bk), bw[:2], sin=sin,
                                **r["op_kw"], device=device)
    return PackedConvOp(ConvConfig.make(*r["args"], **r["kw"]),
                        *r["weights"], sin=sin, **r["op_kw"], device=device)


def block_of(full, meta):
    """The block (r0, r1, n_dp, c0, c1, n_sp) of a whole array: batch rows
    [r0, r1) of n_dp equal parts by dim-1 rows [c0, c1) of n_sp."""
    r0, r1, n_dp, c0, c1, n_sp = (int(m) for m in meta)
    b, d = full.shape[0] // n_dp, full.shape[1] // n_sp
    return full[r0 * b:r1 * b, c0 * d:c1 * d]


def sharded_fn(kind, name, mesh):
    """(the sharded callable, its global inputs, the block this process
    holds) of a run."""
    from deepfusion_tpu_torch.ops.packed import pack_image, pack_image_sharded
    from deepfusion_tpu_torch.parallel import (dp_shard, sp_conv, sp_packed,
                                               tp_fused_conv,
                                               tp_packed_fused)
    from deepfusion_tpu_torch.parallel.plan import three_stage_plan
    r = recipe(name)
    inputs = [torch.from_numpy(a) for a in r["inputs"]]
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if kind == "plan":
        p = PLAN
        fn = three_stage_plan(mesh, p["mb"], p["hw"], p["ic"], p["oc"],
                              p["oc1"],
                              rng=np.random.default_rng(p["seed"]))[0]
        return fn, inputs, (*fn.block[0], dp, *fn.block[1], sp)
    if kind.startswith("tp"):
        wire = kind.split()[1]
        if name == "tp_conv":
            from deepfusion_tpu_torch.config import ConvConfig
            fn = tp_fused_conv(ConvConfig.make(*r["args"], **r["kw"]),
                               *r["weights"], mesh, wire=wire)
        else:
            op = port_op(name)
            fn = tp_packed_fused(op, mesh, wire=wire)
            inputs = [pack_image(inputs[0], op.sin)]
        return fn, inputs, (0, 1, 1, 0, 1, 1)
    op = port_op(name)
    if kind == "dp":
        line = mesh.line("dp", **mesh.home("dp"))
        return dp_shard(op, mesh), inputs, (line.mine[0], line.mine[-1] + 1,
                                            dp, 0, 1, 1)
    dp_axis = "dp" if kind == "sp dp" else None
    if name in ("packed", "pair"):
        fn = sp_packed(op, mesh, dp_axis=dp_axis)
        inputs = [pack_image_sharded(inputs[0], fn.local_spec, sp)]
    else:
        fn = sp_conv(op, mesh, dp_axis=dp_axis)
    return fn, inputs, (*fn.block[0], dp, *fn.block[1], sp)


def collective_part(slot, dt):
    """Slot `slot`'s part for the collectives: a non-contiguous (2, 3, 4, 8)
    view over the whole range of the dtype."""
    rng = np.random.default_rng(200 + slot)
    info = np.iinfo(np.int32 if dt == torch.int32 else np.uint8)
    a = rng.integers(info.min, info.max, (8, 4, 3, 2), dtype=np.int64,
                     endpoint=True)
    return torch.from_numpy(a).to(dt).permute(3, 2, 1, 0)


def run_collectives(line):
    """{"<dtype>|<collective>|<slot>": this process's slots' results}."""
    from deepfusion_tpu_torch.parallel.shard import (all_gather, ppermute,
                                                     psum, psum_scatter)
    n = len(line.devices)
    out = {}
    for dt in (torch.int32, torch.uint8):
        parts = [collective_part(i, dt) for i in line.mine]
        assert not parts[0].is_contiguous()
        res = {"psum": psum(parts, line),
               "psum_scatter": psum_scatter(parts, line, dim=3),
               "all_gather": all_gather(parts, line, dim=3),
               "ppermute": ppermute(parts, line, [(i, (i + 1) % n)
                                                  for i in range(n)])()}
        for k, outs in res.items():
            for i, t in zip(line.mine, outs):
                out[f"{str(dt)[6:]}|{k}|{i}"] = t.numpy()
    return out


def main():
    out_path, slots = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    import torch.distributed as dist
    from deepfusion_tpu_torch.parallel import distributed, make_mesh
    from deepfusion_tpu_torch.utils.logger import CheckError

    if len(sys.argv) > 3:
        port, rank, world = sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
        distributed.initialize(f"localhost:{port}", world, rank,
                               backend="gloo", timeout_s=60)
    else:
        distributed.initialize(timeout_s=60)
    rank, world = dist.get_rank(), dist.get_world_size()
    cpus = ["cpu"] * slots

    def mesh(shape):
        return make_mesh(*shape, local_devices=None if slots == 1 else cpus)

    res = {"world": np.array(world), "backend": np.array(dist.get_backend())}
    m = mesh((1, 1, world * slots))
    line = m.line("tp")
    res["mesh|ranks"] = m.ranks.reshape(-1)
    res["mesh|devices"] = np.array([str(d) for d in m.devices.reshape(-1)])
    res["mesh|mine"] = np.array(line.mine)
    res.update({f"coll|{k}": v for k, v in run_collectives(line).items()})
    for label, name, kind, shape in RUNS["A" if slots == 1 else "B"]:
        msh = mesh(shape)
        fn, inputs, meta = sharded_fn(kind, name, msh)
        msh.wire_bytes = 0
        with torch.inference_mode():
            got = fn(*[block_of(a, meta) for a in inputs])
        res[f"{label}|out"] = got.numpy()
        res[f"{label}|meta"] = np.array(meta)
        res[f"{label}|wire"] = np.array(msh.wire_bytes)
    if slots > 1:
        # a pair shard shallower than ph_a + ph_b is refused (C7)
        from deepfusion_tpu_torch.parallel import sp_packed
        try:
            sp_packed(port_op("shallow_pair"), mesh((1, world * slots, 1)))
        except CheckError as e:
            res["refused"] = np.array(str(e))
    np.savez(out_path, **res)
    dist.destroy_process_group()
    bad = sorted(k for k in sys.modules if k.split(".")[0] in
                 ("jax", "deepfusion_tpu"))
    assert not bad, bad
    print(f"MP_OK {rank} world={world} slots={slots} no_jax", flush=True)


if __name__ == "__main__":
    main()
