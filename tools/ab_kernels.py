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
(``chip_smoke.cold_device_ms``: the L2 evicted before every call); K6,
K7 and K8 (``packed_sum_pool_cuda``) at FusionNet's residual shape and K7
at ResFusionNet's downsample, warm and cold, and K7's per-call ms beside
the 2x2 ``amax`` of the packed interior view; K2 (``concat_cuda``) at
FusionNet's branch merge (two 8x56x56x128 u8 inputs, ReLU), warm and cold,
its per-call ms beside ``torch.cat``'s (taken in turns) and the host us of
``concat_cuda``, of ``concat()`` and of ``torch.cat``; the host us of the
other wrappers at one launch each (K1 at FusionNet's stem and block2, K3's
max pool, K4 at FusionNet's residual sum, with its device time, K5 at
FusionNet's stem and residual, K7 and K9 at ResFusionNet's downsample, K10
at VGGFusion's block 1); then the seven model
paths (FusionNet, ResFusionNet and VGGFusion dense and packed, VGGFusion
hybrid): per-call ms (CUDA events around one call; the median and the
least of 80 calls taken in turns), device ms, the ratio of device ms to
the median (the device's busy share), and for the six
served paths requests/s behind ``BatchServer`` (batch 8, bursts of 64,
median of 3 taken in turns); and the host us of a ``_build.kernels()``
call after the first (the mean of 10,000). K6, K7 and K8 are first
checked bitwise against their plain version.
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

    def in_turns(fns, rounds=2, reps=20):
        """Per-call CUDA-event ms of each fn ({key: fn}), single calls taken
        in turns (reps of A, of B, ..., then of B, A, per round): for each
        key its median over all its calls, and as "<key> min" the least
        (the call the host's neighbours disturbed least)."""
        ms = {k: [] for k in fns}
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        for _ in range(rounds):
            for k in list(fns) + list(fns)[::-1]:
                for _ in range(reps):
                    s = torch.cuda.Event(enable_timing=True)
                    e = torch.cuda.Event(enable_timing=True)
                    s.record()
                    fns[k]()
                    e.record()
                    e.synchronize()
                    ms[k].append(s.elapsed_time(e))
        out = {k: statistics.median(v) for k, v in ms.items()}
        out.update({f"{k} min": min(v) for k, v in ms.items()})
        return out

    def served_rates(paths, rounds=3):
        """Requests/s behind BatchServer, bursts of 64 requests, each
        path's median of `rounds` bursts taken in turns."""
        from deepfusion_tpu_torch.serving import BatchServer
        rps = {k: [] for k in paths}
        for _ in range(rounds):
            for k, (fn, batch, shape) in paths.items():
                req = list(np.random.default_rng(3).integers(
                    0, 256, (64,) + tuple(shape[1:]), dtype=np.uint8))
                with BatchServer(fn, batch=batch,
                                 input_shape=shape[1:]) as srv:
                    t0 = time.perf_counter()
                    for f in srv.submit_many(req):
                        f.result(timeout=300)
                    rps[k].append(len(req) / (time.perf_counter() - t0))
        return {k: statistics.median(v) for k, v in rps.items()}

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
            if b == 1:
                res["K10 VGGFusion block1 host us"] = host_us(
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
            if label == "ResFusionNet down":
                res[f"K9 {label} host us"] = host_us(
                    lambda: CP.convpool_cuda(op, x))
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
        del pop, px
        # K6, K7 and K8 at FusionNet's residual shape, K7 at ResFusionNet's
        # downsample (its one main-path launch), warm and cold, and K7's
        # per-call ms beside the 2x2 amax it replaces
        rng = np.random.default_rng(12)
        pk = net.build_packed()
        rs = pk["res"].sout
        ys = [cs.packed_input(rng, sp, 8, dev)
              for sp in (pk["block1"].sout, pk["branch"].sout)]
        rr = cs.packed_input(rng, rs, 8, dev)
        y2 = torch.cat(ys, dim=-1)
        ds = rnet.build_packed()["down"].sout
        yd = cs.packed_input(rng, ds, 8, dev)
        inner = yd.view(8, ds.rows, ds.iwp, ds.cp)[
            :, ds.halo:ds.halo + ds.h, ds.col_off:ds.col_off + ds.w]
        for label, args in (
                ("K8 FusionNet residual sum+pool",
                 (ys, rr, True, rs.rows, rs.iwp)),
                ("K6 FusionNet residual sum",
                 ([y2], rr, False, rs.rows, rs.iwp)),
                ("K7 FusionNet residual pool",
                 ([y2], None, True, rs.rows, rs.iwp)),
                ("K7 ResFusionNet down", ([yd], None, True, ds.rows,
                                          ds.iwp))):
            assert torch.equal(PK.packed_sum_pool_cuda(*args),
                               PK.packed_sum_pool_plain(*args)), label
            res[label] = device_ms(lambda: PK.packed_sum_pool_cuda(*args))
            res[f"{label} cold"] = cold_ms(
                lambda: PK.packed_sum_pool_cuda(*args))
        res["K7 ResFusionNet down host us"] = host_us(
            lambda: PK.packed_sum_pool_cuda([yd], None, True, ds.rows,
                                            ds.iwp))
        # K4 at FusionNet's residual sum (dense), two 8x56x56x256 u8
        ya, yb = (cs.rand(rng, (8, hw, hw, 2 * w), u8, dev) for _ in "ab")
        res["K4 FusionNet residual"] = device_ms(
            lambda: P.sum_relu_cuda(ya, yb, u8, True))
        res["K4 FusionNet residual host us"] = host_us(
            lambda: P.sum_relu_cuda(ya, yb, u8, True))
        res.update(in_turns({
            "K7 ResFusionNet down per call ms":
                lambda: PK.packed_sum_pool_cuda([yd], None, True, ds.rows,
                                                ds.iwp),
            "2x2 amax ResFusionNet down per call ms":
                lambda: inner.unflatten(1, (ds.h // 2, 2)).unflatten(
                    3, (ds.w // 2, 2)).amax(dim=(2, 4))}))
        # K2 at FusionNet's branch merge
        from deepfusion_tpu_torch.config import ConcatConfig
        C = importlib.import_module("deepfusion_tpu_torch.ops.concat")
        xs = [cs.rand(rng, (8, hw, hw, w), u8, dev) for _ in range(2)]
        ccfg = ConcatConfig.make([tuple(x.shape) for x in xs], u8, True)
        assert torch.equal(C.concat_cuda(xs, ccfg), C.concat_plain(xs, ccfg))
        label = "FusionNet branch merge"
        res[f"K2 {label}"] = device_ms(lambda: C.concat_cuda(xs, ccfg))
        res[f"K2 {label} cold"] = cold_ms(lambda: C.concat_cuda(xs, ccfg))
        res[f"K2 {label} host us"] = host_us(lambda: C.concat_cuda(xs, ccfg))
        res[f"K2 concat() {label} host us"] = host_us(
            lambda: C.concat(xs, post_relu=True))
        res[f"torch.cat {label} host us"] = host_us(
            lambda: torch.cat(xs, dim=-1))
        res.update(in_turns({
            f"K2 {label} per call ms": lambda: C.concat_cuda(xs, ccfg),
            f"torch.cat {label} per call ms":
                lambda: torch.cat(xs, dim=-1)}))
        # the host's time of the library lookup every launch makes
        from deepfusion_tpu_torch import _build
        _build.kernels()
        t0 = time.perf_counter()
        for _ in range(10000):
            _build.kernels()
        res["_build.kernels() host us"] = (
            (time.perf_counter() - t0) / 10000 * 1e6)
        # the seven model paths: per-call ms (taken in turns), device ms,
        # the busy share, and served requests/s (bursts in turns)
        fwd, served = {}, {}
        for model in (net, rnet, vnet):
            name = type(model).__name__
            xm = torch.from_numpy(model.example_input()).to(dev)
            pm = model.packed_module()
            fwd[f"{name} dense"] = lambda m=model, x=xm: m(x)
            fwd[f"{name} packed"] = lambda m=pm, x=xm: m(x)
            served[f"{name} dense"] = (model, model.cfg.batch,
                                       model.input_shape)
            served[f"{name} packed"] = (pm, model.cfg.batch,
                                        model.input_shape)
        fwd["VGGFusion hybrid"] = lambda x=xm: vnet.hybrid_call(x)
        for k, v in in_turns(fwd).items():
            res[f"{k.replace(' min', '')} forward per call "
                f"{'min ' if k.endswith(' min') else ''}ms"] = v
        for k, fn in fwd.items():
            d = device_ms(fn)
            res[f"{k} forward device ms"] = d
            res[f"{k} forward busy share"] = d / res[
                f"{k} forward per call ms"]
    for k, v in served_rates(served).items():
        res[f"{k} served requests/s"] = v
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
