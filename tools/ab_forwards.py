"""Host-side A/B of the model paths of two trees of the repository on one
card: per-call ms and served requests/s, in alternating processes.

    python3 tools/ab_forwards.py PARENT CHANGE [PAIRS]

Runs PAIRS (default 10) pairs of processes, PARENT then CHANGE in the even
pairs and CHANGE then PARENT in the odd ones; each process imports
``deepfusion_tpu_torch`` from its tree (which builds its own kernels on its
first run), builds FusionNet, ResFusionNet and VGGFusion at full width
(batch 8) on the card, and measures the seven paths (each model dense and
packed, VGGFusion hybrid): per-call ms (CUDA events around one call, 100
calls of each path taken in turns; the median and the least), and for the
six served paths requests/s behind ``BatchServer`` (one burst of 64
requests after a warm-up burst). These numbers are host-bound (PERF.md
§5): between two processes of one tree they move far more than the device
time does, so a difference counts only where the change wins or loses
nearly every pair. Prints one JSON line per process, then per path and
metric each tree's median and quartiles and the pairs the change won.
"""
import json
import os
import statistics
import subprocess
import sys
import time


def run_tree(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from deepfusion_tpu_torch.models import (FusionNet, FusionNetConfig,
                                             ResFusionNet, ResFusionNetConfig,
                                             VGGFusion, VGGFusionConfig)
    from deepfusion_tpu_torch.serving import BatchServer
    dev = torch.device("cuda:0")
    fwd, served = {}, {}
    with torch.inference_mode():
        for model in (FusionNet(FusionNetConfig(), device=dev),
                      ResFusionNet(ResFusionNetConfig(), device=dev),
                      VGGFusion(VGGFusionConfig(), device=dev)):
            name = type(model).__name__
            x = torch.from_numpy(model.example_input()).to(dev)
            pm = model.packed_module()
            fwd[f"{name} dense"] = lambda m=model, x=x: m(x)
            fwd[f"{name} packed"] = lambda m=pm, x=x: m(x)
            served[f"{name} dense"] = (model, model.input_shape)
            served[f"{name} packed"] = (pm, model.input_shape)
            if name == "VGGFusion":
                fwd[f"{name} hybrid"] = lambda m=model, x=x: m.hybrid_call(
                    x)
        ms = {k: [] for k in fwd}
        for fn in fwd.values():
            fn()
        torch.cuda.synchronize()
        for _ in range(20):
            for k, fn in fwd.items():
                for _ in range(5):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    fn()
                    e.record()
                    e.synchronize()
                    ms[k].append(s.elapsed_time(e))
    res = {}
    for k, v in ms.items():
        res[f"{k} per call ms"] = statistics.median(v)
        res[f"{k} per call min ms"] = min(v)
    for k, (fn, shape) in served.items():
        req = list(np.random.default_rng(3).integers(
            0, 256, (64,) + tuple(shape[1:]), dtype=np.uint8))
        with BatchServer(fn, batch=8, input_shape=shape[1:]) as srv:
            for f in srv.submit_many(req):
                f.result(timeout=300)
            t0 = time.perf_counter()
            for f in srv.submit_many(req):
                f.result(timeout=300)
            res[f"{k} served requests/s"] = len(req) / (
                time.perf_counter() - t0)
    print(json.dumps({"tree": tree, "res": res}), flush=True)


def main():
    args = sys.argv[1:]
    if args[:1] == ["--run"]:
        run_tree(args[1])
        return
    parent, change = args[:2]
    pairs = int(args[2]) if len(args) > 2 else 10
    runs = []
    for i in range(pairs):
        for tree in ((parent, change) if i % 2 == 0 else (change, parent)):
            out = subprocess.run([sys.executable, __file__, "--run", tree],
                                 capture_output=True, text=True, check=True)
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    for key in runs[0]["res"]:
        a = [r["res"][key] for r in runs if r["tree"] == parent]
        b = [r["res"][key] for r in runs if r["tree"] == change]
        # pairs in which the change is better: lower ms, higher rates
        better = sum((y > x) if key.endswith("/s") else (y < x)
                     for x, y in zip(a, b))
        q = [statistics.quantiles(v, n=4) for v in (a, b)]
        print(f"{key}: parent median {statistics.median(a):.5g} "
              f"(quartiles {q[0][0]:.5g}-{q[0][2]:.5g}), change median "
              f"{statistics.median(b):.5g} (quartiles {q[1][0]:.5g}-"
              f"{q[1][2]:.5g}), change better in {better} of {len(a)} "
              f"pairs")


if __name__ == "__main__":
    main()
