"""Device time of the kernels at the models' layers, for an A/B of two
trees of the repository on one card.

    python3 tools/ab_kernels.py TREE [TREE ...]

Runs itself once per TREE, in the order given, each in its own process
that imports ``deepfusion_tpu_torch`` from that tree (which builds its own
kernels): K1 (``conv_cuda``) at every dense layer of FusionNet, ResFusionNet
and VGGFusion (the heads included; with the sums per model) and at
bench.py's --dense shape, warm and cold, K5 (``packed_conv_cuda``)
at FusionNet's and ResFusionNet's packed layers and at bench.py's default
shape (8x126x126x256 -> 3x3:256 -> 1x1:256), K9 (``convpool_cuda``) at
ResFusionNet's downsample and VGGFusion's three conv+pool layers (beside
each, the same layer as K1 then K3's 2x2 max pool), K10
(``pair_conv_cuda``) at VGGFusion's blocks (beside each, the block as K5's
conv a then conv b with its fused pool) and at bench.py's --pair shape, K3
(``pool_cuda``) at its four model launches (FusionNet's 2x2 max pool and
global average, ResFusionNet's and VGGFusion's global averages); full
width, batch 8, inputs from seed 0. Each time is ``chip_smoke.device_ms``:
the median of 3 ``torch.profiler`` profiles of 50 calls (self device time
per call, ms); K1, K3, K9, K10 and the bench shapes also cold
(``chip_smoke.cold_device_ms``: the L2 evicted before every call).
Entries ending in "host us" are the host's time per call of the wrapper (a
loop of 200 calls that the device keeps up with, no synchronisation
inside; median of 5 loops, microseconds). Give the trees as parent,
change, change, parent. Prints one JSON line per run, then the median per
tree of each entry and, for the bench shapes, TOP/s.
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402  (this checkout's; imports no package)


def run_tree(tree):
    # the tree's package, ahead of this checkout's
    sys.path.insert(0, os.path.abspath(tree))
    import importlib

    import numpy as np
    import torch
    from deepfusion_tpu_torch.models import (FusionNet, FusionNetConfig,
                                             ResFusionNet, ResFusionNetConfig,
                                             VGGFusion, VGGFusionConfig)
    from deepfusion_tpu_torch.models.fusionnet import LAYERS
    from deepfusion_tpu_torch.types import dtype
    from deepfusion_tpu_torch.config import PoolConfig
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    M = importlib.import_module("deepfusion_tpu_torch.ops.mega")
    CP = importlib.import_module("deepfusion_tpu_torch.ops.convpool")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)

    def device_ms(fn):
        return cs.device_ms(fn, reps=50, profiles=3)

    def cold_ms(fn):
        return cs.cold_device_ms(fn, reps=50, profiles=3)

    def host_us(fn, calls=200, loops=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(loops):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        return statistics.median(out)

    u8 = dtype.u8
    res = {}
    with torch.inference_mode():
        net = FusionNet(FusionNetConfig(), device=dev)
        rnet = ResFusionNet(ResFusionNetConfig(), device=dev)
        vnet = VGGFusion(VGGFusionConfig(), device=dev)
        # K1 at every dense launch of the three forwards, warm and cold
        k1 = [("FusionNet", n, getattr(net, n)) for n in LAYERS]
        k1 += [("ResFusionNet", n, getattr(rnet, n))
               for n in ("stem", "block1", "block2", "head")]
        k1 += [("VGGFusion", f"block{b}_conv1", op)
               for b, op in enumerate(vnet.conv1, 1)]
        k1 += [("VGGFusion", "head", vnet.head)]
        sums = {}
        for model, name, op in k1:
            c = op.cfg
            x = cs.rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
            sm = cs.rand(rng, (c.bs, c.oh, c.ow, c.out_oc), u8, dev) \
                if c.with_sum else None
            warm = device_ms(lambda: K.conv_cuda(op, x, sm))
            cold = cold_ms(lambda: K.conv_cuda(op, x, sm))
            res[f"K1 {model} {name}"] = warm
            res[f"K1 {model} {name} cold"] = cold
            group = "heads" if name == "head" else f"{model} dense"
            for key, v in ((f"K1 sum {group}", warm),
                           (f"K1 sum {group} cold", cold)):
                sums[key] = sums.get(key, 0.0) + v
            if (model, name) in (("FusionNet", "stem"),
                                 ("FusionNet", "block2")):
                res[f"K1 {model} {name} host us"] = host_us(
                    lambda: K.conv_cuda(op, x, sm))
        res.update(sums)
        for model in (net, rnet):
            n = model.cfg.batch
            for name, op in model.build_packed().items():
                arrs = [cs.packed_input(rng, s, n, dev) for s in op.sins]
                sm = None if op.ssum is None else cs.packed_input(
                    rng, op.ssum, n, dev)
                res[f"K5 {type(model).__name__} {name}"] = device_ms(
                    lambda: PK.packed_conv_cuda(op, arrs, sm))
                if model is net and name in ("stem", "res"):
                    res[f"K5 FusionNet {name} host us"] = host_us(
                        lambda: PK.packed_conv_cuda(op, arrs, sm))
        for b, pair in enumerate(vnet.build_packed(), 1):
            x = cs.packed_input(rng, pair.sin, vnet.cfg.batch, dev)
            res[f"K10 VGGFusion block{b}"] = device_ms(
                lambda: M.pair_conv_cuda(pair, x))
            res[f"K10 VGGFusion block{b} cold"] = cold_ms(
                lambda: M.pair_conv_cuda(pair, x))

            def two():
                return PK.packed_conv_cuda(pair.op_b, [PK.packed_conv_cuda(
                    pair.op_a, [x])])
            res[f"K5 + K5 pool2 VGGFusion block{b}"] = device_ms(two)
            res[f"K5 + K5 pool2 VGGFusion block{b} cold"] = cold_ms(two)
        for label, op, params in [("ResFusionNet down", rnet.down,
                                   rnet.params["down"])] + [
                (f"VGGFusion block{b} conv2+pool", op,
                 vnet.params[f"block{b}_conv2"])
                for b, op in enumerate(vnet.convpool2, 1)]:
            c = op.cfg
            x = cs.rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
            res[f"K9 {label}"] = device_ms(lambda: CP.convpool_cuda(op, x))
            res[f"K9 {label} cold"] = cold_ms(lambda: CP.convpool_cuda(op, x))
            cop = K.ConvOp(c, params["wei"], params.get("bia"), device=dev)

            def composed():
                return P.pool_cuda(K.conv_cuda(cop, x), op.pc, u8)
            res[f"K1 + K3 {label}"] = device_ms(composed)
            res[f"K1 + K3 {label} cold"] = cold_ms(composed)
        # K3 at its model launches
        hw, w = net.cfg.hw, net.cfg.width
        r, v = rnet.block2.cfg, vnet.convpool2[-1].cfg
        pools = [("FusionNet maxpool 2x2/s2", (8, hw, hw, 2 * w), "max",
                  (2, 2)),
                 ("FusionNet global avg", (8, hw // 2, hw // 2, w),
                  "avg_exc", None),
                 ("ResFusionNet global avg", (r.bs, r.oh, r.ow, r.out_oc),
                  "avg_exc", None),
                 ("VGGFusion global avg",
                  (v.bs, v.oh // 2, v.ow // 2, v.out_oc), "avg_exc", None)]
        for label, shape, kind, k in pools:
            x = cs.rand(rng, shape, u8, dev)
            k = k or shape[1:3]
            pc = PoolConfig.make(kind, shape[1:3], k, k, (0, 0))
            res[f"K3 {label}"] = device_ms(lambda: P.pool_cuda(x, pc, u8))
            res[f"K3 {label} cold"] = cold_ms(lambda: P.pool_cuda(x, pc, u8))
            if kind == "max":
                res[f"K3 {label} host us"] = host_us(
                    lambda: P.pool_cuda(x, pc, u8))
        # the host's time of the packed forwards, which launch K5
        for model in (net, rnet):
            xm = torch.from_numpy(model.example_input()).to(dev)
            pm = model.packed_module()
            res[f"{type(model).__name__} packed forward host us"] = host_us(
                lambda: pm(xm), calls=50)
        # K5 at bench.py's default shape
        fop, fb, macs = cs.flagship_op(dev)
        fx = cs.packed_input(rng, fop.sin, fb, dev)
        res["K5 bench.py default"] = device_ms(
            lambda: PK.packed_conv_cuda(fop, [fx]))
        res["K5 bench.py default cold"] = cold_ms(
            lambda: PK.packed_conv_cuda(fop, [fx]))
        del fop, fx
        # K1 at bench.py's --dense shape (the same layer, NHWC u8)
        dop, macs = cs.flagship_dense(dev)
        c = dop.cfg
        dx = cs.rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
        res["K1 bench.py --dense"] = device_ms(lambda: K.conv_cuda(dop, dx))
        res["K1 bench.py --dense cold"] = cold_ms(
            lambda: K.conv_cuda(dop, dx))
        del dop, dx
        # K10 at bench.py's --pair shape (two of its default layers)
        pop, pb, pmacs = cs.flagship_pair(dev)
        px = cs.packed_input(rng, pop.sin, pb, dev)
        res["K10 bench.py --pair"] = device_ms(
            lambda: M.pair_conv_cuda(pop, px))
        res["K10 bench.py --pair cold"] = cold_ms(
            lambda: M.pair_conv_cuda(pop, px))
    print(json.dumps({"tree": tree, "device_ms": res, "bench_macs": macs,
                      "pair_macs": pmacs}), flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--run"]:
        run_tree(args[1])
        return
    runs = []
    for tree in args:
        out = subprocess.run([sys.executable, __file__, "--run", tree],
                             capture_output=True, text=True, check=True)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    trees = list(dict.fromkeys(args))
    for layer in runs[0]["device_ms"]:
        meds = [statistics.median(r["device_ms"][layer] for r in runs
                                  if r["tree"] == t) for t in trees]
        line = f"{layer}: " + " ".join(f"{t}={m:.5f}" for t, m in
                                       zip(trees, meds))
        if len(meds) == 2:
            line += f" ratio={meds[1] / meds[0]:.4f}"
        if layer.startswith(("K5 bench.py", "K1 bench.py", "K10 bench.py")):
            key = "pair_macs" if layer.startswith("K10") else "bench_macs"
            line += " TOP/s " + " ".join(
                f"{t}={2 * runs[0][key] / m / 1e9:.1f}"
                for t, m in zip(trees, meds))
        print(line)


if __name__ == "__main__":
    main()
