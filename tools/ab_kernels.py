"""Device time of the conv kernels at the models' layers, for an A/B of two
trees of the repository on one card.

    python3 tools/ab_kernels.py TREE [TREE ...]

Runs itself once per TREE, in the order given, each in its own process
that imports ``deepfusion_tpu_torch`` from that tree (which builds its own
kernels): K1 (``conv_cuda``) at FusionNet's layers, K5 (``packed_conv_cuda``)
at FusionNet's and ResFusionNet's packed layers, K10 (``pair_conv_cuda``)
at VGGFusion's blocks, full width, batch 8, inputs from seed 0. Each time
is ``chip_smoke.device_ms``: the median of 3 ``torch.profiler`` profiles of
50 calls (self device time per call, ms). Give the trees as parent,
change, change, parent. Prints one JSON line per run, then the median per
tree of each layer.
"""
import json
import os
import statistics
import subprocess
import sys

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
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    M = importlib.import_module("deepfusion_tpu_torch.ops.mega")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)

    def device_ms(fn):
        return cs.device_ms(fn, reps=50, profiles=3)

    res = {}
    with torch.inference_mode():
        net = FusionNet(FusionNetConfig(), device=dev)
        for name in LAYERS:
            op = getattr(net, name)
            c = op.cfg
            x = cs.rand(rng, (c.bs, c.ih, c.iw, c.ic), dtype.u8, dev)
            res[f"K1 FusionNet {name}"] = device_ms(lambda: K.conv_cuda(op, x))
        for model in (net, ResFusionNet(ResFusionNetConfig(), device=dev)):
            n = model.cfg.batch
            for name, op in model.build_packed().items():
                arrs = [cs.packed_input(rng, s, n, dev) for s in op.sins]
                sm = None if op.ssum is None else cs.packed_input(
                    rng, op.ssum, n, dev)
                res[f"K5 {type(model).__name__} {name}"] = device_ms(
                    lambda: PK.packed_conv_cuda(op, arrs, sm))
        vnet = VGGFusion(VGGFusionConfig(), device=dev)
        for b, pair in enumerate(vnet.build_packed(), 1):
            x = cs.packed_input(rng, pair.sin, vnet.cfg.batch, dev)
            res[f"K10 VGGFusion block{b}"] = device_ms(
                lambda: M.pair_conv_cuda(pair, x))
    print(json.dumps({"tree": tree, "device_ms": res}), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run_tree(sys.argv[2])
        return
    runs = []
    for tree in sys.argv[1:]:
        out = subprocess.run([sys.executable, __file__, "--run", tree],
                             capture_output=True, text=True, check=True)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    trees = list(dict.fromkeys(sys.argv[1:]))
    for layer in runs[0]["device_ms"]:
        meds = [statistics.median(r["device_ms"][layer] for r in runs
                                  if r["tree"] == t) for t in trees]
        print(f"{layer}: " + " ".join(f"{t}={m:.5f}" for t, m in
                                      zip(trees, meds))
              + (f" ratio={meds[1] / meds[0]:.4f}" if len(meds) == 2 else ""))


if __name__ == "__main__":
    main()
