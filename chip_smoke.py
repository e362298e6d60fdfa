"""Drive the PyTorch port's main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit, compute capability 9.0;
  2. build: compile the CUDA kernels of deepfusion_tpu_torch/csrc;
  3. parity: each kernel against its plain PyTorch version on the card,
     bitwise, at every FusionNet full-width layer shape and extra cases
     (every dtype, both round modes, saturation edges);
  4. slice: FusionNet(FusionNetConfig()) on the card behind BatchServer
     answers 20 requests; each answer must equal the plain forward on the
     CPU bitwise (and the JAX package's golden logits where stored), and
     every kernel must have been launched;
  5. timings: CUDA-event medians of each kernel and its plain version at
     the model's shapes, one forward, and served requests per second.

Any failure raises and exits non-zero; nothing is caught. The line before
the last is the per-kernel JSON summary, the last line the device JSON.
"""
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

REPS = 20
GOLDEN = os.path.join(ROOT, "tests", "data", "fusionnet_full_logits.npz")
KERNEL_INFO = {
    "conv_fused": ("deepfusion_tpu_torch/csrc/conv.cu",
                   "deepfusion_tpu/ops/conv.py:163",
                   "deepfusion_tpu/ops/conv.py:187"),
    "concat_relu": ("deepfusion_tpu_torch/csrc/concat.cu",
                    "deepfusion_tpu/ops/concat.py:61", None),
    "pool": ("deepfusion_tpu_torch/csrc/pool.cu",
             "deepfusion_tpu/ops/pool.py:62", None),
    "sum_relu": ("deepfusion_tpu_torch/csrc/sum_relu.cu",
                 "deepfusion_tpu/ops/pool.py:225", None),
}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS, warmup=3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(fn, reps=REPS):
    """Device time per call of fn() in ms: the self device time of every
    kernel and copy it ran, summed by torch.profiler over reps calls
    (0.0 when the profiler records no device activity)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / reps / 1e3


def rand(rng, shape, dt, dev):
    """Full-range random tensor of a port dtype, saturation edges included."""
    from deepfusion_tpu_torch.types import dtype
    if dt == dtype.f32:
        a = (rng.standard_normal(shape) * 100).astype(np.float32)
    else:
        info = np.iinfo(dt.np)
        a = rng.integers(info.min, info.max, shape, dtype=np.int64,
                         endpoint=True).astype(dt.np)
        flat = a.reshape(-1)
        flat[:4] = [info.min, info.max, info.min + 1, info.max - 1][:4]
    return torch.from_numpy(a).to(dev)


class Parity:
    """Bitwise comparison of a kernel with its plain version."""

    def __init__(self):
        self.cases = {k: 0 for k in KERNEL_INFO}
        self.err = {k: 0.0 for k in KERNEL_INFO}

    def check(self, kernel: str, what: str, got, want):
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, \
            f"{kernel} {what}: {got.shape}/{got.dtype} vs " \
            f"{want.shape}/{want.dtype}"
        g, w = got.cpu().numpy(), want.cpu().numpy()
        err = float(np.max(np.abs(g.astype(np.float64) - w.astype(np.float64)),
                           initial=0.0))
        self.err[kernel] = max(self.err[kernel], err)
        self.cases[kernel] += 1
        if not np.array_equal(g, w, equal_nan=True):
            bad = np.argwhere(g != w)[:5]
            raise AssertionError(
                f"{kernel} {what}: not bitwise equal to the plain version; "
                f"max_abs_err {err}, first mismatches at {bad.tolist()}")


def phase_device():
    from deepfusion_tpu_torch.utils.logger import check
    check(torch.cuda.is_available(), "no CUDA device")
    name_power = card()
    cap = torch.cuda.get_device_capability(0)
    print(f"device: {name_power} | capability {cap} | "
          f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    check(cap == (9, 0), f"need compute capability (9, 0), got {cap}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return name_power


def phase_build():
    from deepfusion_tpu_torch import _build
    t0 = time.perf_counter()
    _build.kernels()
    print(f"build: {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def conv_cases(dev):
    """(label, ConvOp, input) for the extra K1 cases."""
    from deepfusion_tpu_torch.config import ConvConfig
    from deepfusion_tpu_torch.ops.conv import ConvOp
    from deepfusion_tpu_torch.utils.mathutil import conv_output_size
    rng = np.random.default_rng(11)
    out = []

    def add(label, n, hw, ic, oc, k, s, p, dst, *, oc1=None, bias=True,
            per_oc=True, rnd="nearest", relu=True, scale=None):
        o = conv_output_size(hw, k, s, p)
        wei = rng.integers(-128, 128, (oc, ic, k, k)).astype(np.int8)
        bia = rng.integers(-5000, 5000, (oc,)).astype(np.int32) \
            if bias else None
        sc = scale if scale is not None else 1.0 / (k * k * ic * 60)
        sc0 = (rng.uniform(0.5, 1.5, oc) * sc).astype(np.float32) \
            if per_oc else (sc,)
        kw = {}
        if oc1 is not None:
            kw = dict(wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=np.int32,
                      conv1_relu=relu, conv1_round=rnd,
                      conv1_scales=(rng.uniform(0.5, 1.5, oc1) * sc
                                    ).astype(np.float32) if per_oc else (sc,))
        cfg = ConvConfig.make((n, hw, hw, ic), (oc, ic, k, k),
                              None if bia is None else bia.dtype, (s, s),
                              (p, p), (n, o, o, oc1 or oc), dst,
                              conv0_relu=relu, conv0_scales=sc0,
                              conv0_round=rnd, **kw)
        wei1 = bia1 = None
        if oc1 is not None:
            wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
            bia1 = rng.integers(-5000, 5000, (oc1,)).astype(np.int32)
        x = torch.from_numpy(rng.integers(0, 256, (n, hw, hw, ic),
                                          dtype=np.uint8)).to(dev)
        out.append((label, ConvOp(cfg, wei, bia, wei1, bia1, device=dev), x))

    for dst in ("u8", "s8", "s32", "f32"):
        for rnd in ("nearest", "down"):
            add(f"3x3 {dst} {rnd}", 2, 12, 32, 64, 3, 1, 1, dst, rnd=rnd,
                relu=dst != "s8")
            add(f"fused {dst} {rnd}", 2, 12, 64, 64, 3, 1, 1, dst, oc1=32,
                rnd=rnd, relu=dst == "u8")
    add("no-bias scalar-scale", 2, 10, 32, 40, 3, 1, 1, "s8", bias=False,
        per_oc=False, relu=False)
    add("ic=3 oc=20 5x5 stride2 pad2", 2, 17, 3, 20, 5, 2, 2, "u8")
    add("1x1 stride2", 2, 9, 48, 24, 1, 2, 0, "s32", relu=False)
    add("fused oc1>oc0", 1, 8, 32, 16, 3, 1, 1, "s8", oc1=72, relu=False)
    add("1x1 oc=1040 (two channel passes)", 1, 5, 64, 1040, 1, 1, 0, "s32",
        relu=False)
    add("fused oc0=1032 oc1=40", 1, 4, 32, 1032, 3, 1, 1, "u8", oc1=40)
    for dst in ("u8", "s8", "s32"):   # saturation at both ends
        add(f"saturate {dst}", 1, 8, 64, 32, 3, 1, 1, dst, relu=False,
            scale=1e6 if dst == "s32" else 0.05)
    return out


def phase_parity(net, dev) -> Parity:
    from deepfusion_tpu_torch.config import ConcatConfig, PoolConfig
    from deepfusion_tpu_torch.models.fusionnet import LAYERS
    C = importlib.import_module("deepfusion_tpu_torch.ops.concat")
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    from deepfusion_tpu_torch.types import dtype
    rng = np.random.default_rng(5)
    par = Parity()
    u8 = dtype.u8

    # K1: every FusionNet full-width layer, then the extra cases
    for name in LAYERS:
        op = getattr(net, name)
        cfg = op.cfg
        x = rand(rng, (cfg.bs, cfg.ih, cfg.iw, cfg.ic), u8, dev)
        par.check("conv_fused", f"FusionNet {name}", K.conv_cuda(op, x),
                  K.conv_plain(op, x))
    for label, op, x in conv_cases(dev):
        par.check("conv_fused", label, K.conv_cuda(op, x),
                  K.conv_plain(op, x))

    # K2: the branch merge, then every dtype with 1-3 inputs
    cases = [(u8, [128, 128], (8, 56, 56), True)]
    for dt in (dtype.u8, dtype.s8, dtype.s32, dtype.f32):
        for ics in ([64], [16, 48] if dt.size == 1 else [4, 12],
                    [32, 16, 64] if dt.size == 1 else [8, 4, 16]):
            for relu in (False, True):
                cases.append((dt, ics, (2, 5, 7), relu))
    for dt, ics, nhw, relu in cases:
        xs = [rand(rng, nhw + (ic,), dt, dev) for ic in ics]
        cfg = ConcatConfig.make([tuple(x.shape) for x in xs], dt, relu)
        par.check("concat_relu", f"{dt.name} {ics} relu={relu}",
                  C.concat_cuda(xs, cfg), C.concat_plain(xs, cfg))

    # K3: the model's two pools, then every dtype and kind
    pcases = [(u8, (8, 56, 56, 256), "max", (2, 2), (2, 2), (0, 0)),
              (u8, (8, 28, 28, 128), "avg_exc", (28, 28), (28, 28), (0, 0))]
    for dt in (dtype.u8, dtype.s8, dtype.s32, dtype.f32):
        for kind in ("max", "avg_inc", "avg_exc"):
            pcases += [(dt, (2, 9, 11, 40), kind, (3, 3), (2, 2), (1, 1)),
                       (dt, (2, 9, 9, 24), kind, (2, 2), (2, 2), (0, 0)),
                       (dt, (2, 12, 12, 40), kind, (12, 12), (12, 12),
                        (0, 0))]
    for dt, shape, kind, k, s, p in pcases:
        x = rand(rng, shape, dt, dev)
        for rnd in (("nearest", "down") if kind != "max" and dt.is_int
                    else ("nearest",)):
            pc = PoolConfig.make(kind, shape[1:3], k, s, p, rnd)
            par.check("pool", f"{dt.name} {shape} {kind} k{k} s{s} p{p} "
                      f"{rnd}", P.pool_cuda(x, pc, dt),
                      P.pool_plain(x, pc, dt))

    # K4: the residual, then every dtype, with a ragged tail
    scases = [(u8, (8, 56, 56, 256))]
    for dt in (dtype.u8, dtype.s8, dtype.s32, dtype.f32):
        scases += [(dt, (2, 7, 9, 32)), (dt, (1, 3, 5, 7))]
    for dt, shape in scases:
        a, b = rand(rng, shape, dt, dev), rand(rng, shape, dt, dev)
        for relu in (True, False):
            par.check("sum_relu", f"{dt.name} {shape} relu={relu}",
                      P.sum_relu_cuda(a, b, dt, relu),
                      P.sum_relu_plain(a, b, dt, relu))
    for k in KERNEL_INFO:
        print(f"parity: {k} bitwise equal to its plain version in "
              f"{par.cases[k]} cases, max_abs_err {par.err[k]}", flush=True)
    return par


def phase_slice(net, cfg, dev) -> dict:
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.models import FusionNet
    from deepfusion_tpu_torch.serving import BatchServer
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    reqs = []
    golden = None
    if os.path.exists(GOLDEN):
        golden = np.load(GOLDEN)
        check_eq(int(golden["model_seed"]), cfg.seed, "golden model seed")
        reqs += list(net.example_input(
            np.random.default_rng(int(golden["input_seed"]))))
    rng = np.random.default_rng(123)
    while len(reqs) < 20:
        reqs.append(rng.integers(0, 256, net.input_shape[1:], dtype=np.uint8))

    _build.reset_launch_counts()
    srv = BatchServer(net, batch=cfg.batch, input_shape=net.input_shape[1:])
    with srv:
        outs = [f.result(timeout=300) for f in srv.submit_many(reqs)]
    counts = _build.launch_counts()
    print(f"slice: 20 requests served in {srv.stats['flushes']} flushes "
          f"({srv.stats['padded_rows']} padded rows); launches {counts}",
          flush=True)
    check_eq(srv.stats["requests"], 20, "served requests")
    for k in KERNEL_INFO:
        check(counts[k] > 0, f"kernel {k} was not launched on the main path")

    got = np.stack(outs)
    check_eq(got.shape, (20, cfg.num_classes), "served logits shape")
    check(got.dtype == np.float32 and np.isfinite(got).all(),
          "served logits must be finite f32")
    cpu_net = FusionNet(cfg, device="cpu")
    with torch.inference_mode():
        want = cpu_net(np.stack(reqs)).numpy()
    check(np.array_equal(got, want),
          f"served logits differ from the CPU plain forward: max_abs_err "
          f"{np.abs(got - want).max()}")
    msg = "bitwise equal to the CPU plain forward"
    if golden is not None:
        check(np.array_equal(got[:cfg.batch], golden["logits"]),
              "card logits differ from the JAX package's golden logits: "
              f"max_abs_err {np.abs(got[:cfg.batch] - golden['logits']).max()}")
        msg += " and to the JAX package's golden logits"
    print(f"slice: 20 served answers {msg}", flush=True)
    return counts


def phase_timings(net, cfg, dev, name_power, parity, counts) -> list:
    from deepfusion_tpu_torch.config import ConcatConfig, PoolConfig
    from deepfusion_tpu_torch.models.fusionnet import LAYERS
    C = importlib.import_module("deepfusion_tpu_torch.ops.concat")
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    from deepfusion_tpu_torch.serving import BatchServer
    from deepfusion_tpu_torch.types import dtype
    rng = np.random.default_rng(9)
    u8 = dtype.u8
    per = {k: [0.0, 0.0, 0.0, 0.0] for k in KERNEL_INFO}

    def timed(kernel, label, fn_kernel, fn_plain):
        t = (cuda_ms(fn_kernel), cuda_ms(fn_plain), device_ms(fn_kernel),
             device_ms(fn_plain))
        for i, v in enumerate(t):
            per[kernel][i] += v
        print(f"timing: {kernel} {label} ms={t[0]:.4f} plain_ms={t[1]:.4f} "
              f"device_ms={t[2]:.4f} plain_device_ms={t[3]:.4f} "
              f"card=\"{name_power}\"", flush=True)

    w = cfg.width
    with torch.inference_mode():
        for name in LAYERS:
            op = getattr(net, name)
            c = op.cfg
            x = rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
            timed("conv_fused", name, lambda: K.conv_cuda(op, x),
                  lambda: K.conv_plain(op, x))
        n, hw = cfg.batch, cfg.hw
        xs = [rand(rng, (n, hw, hw, w), u8, dev) for _ in range(2)]
        ccfg = ConcatConfig.make([tuple(x.shape) for x in xs], u8, True)
        timed("concat_relu", "branch merge", lambda: C.concat_cuda(xs, ccfg),
              lambda: C.concat_plain(xs, ccfg))
        y = rand(rng, (n, hw, hw, 2 * w), u8, dev)
        r = rand(rng, (n, hw, hw, 2 * w), u8, dev)
        timed("sum_relu", "residual", lambda: P.sum_relu_cuda(y, r, u8, True),
              lambda: P.sum_relu_plain(y, r, u8, True))
        pc = PoolConfig.make("max", (hw, hw), (2, 2), (2, 2), (0, 0))
        timed("pool", "maxpool 2x2/s2", lambda: P.pool_cuda(y, pc, u8),
              lambda: P.pool_plain(y, pc, u8))
        h2 = hw // 2
        z = rand(rng, (n, h2, h2, w), u8, dev)
        pc2 = PoolConfig.make("avg_exc", (h2, h2), (h2, h2), (h2, h2), (0, 0))
        timed("pool", "global avg_exc", lambda: P.pool_cuda(z, pc2, u8),
              lambda: P.pool_plain(z, pc2, u8))

        x = torch.from_numpy(net.example_input()).to(dev)
        fwd_ms = cuda_ms(lambda: net(x))
        fwd_dev_ms = device_ms(lambda: net(x))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                net(x)
            torch.cuda.synchronize()
    print(f"timing: FusionNet forward batch={cfg.batch} ms={fwd_ms:.4f} "
          f"device_ms={fwd_dev_ms:.4f} device_busy_share="
          f"{fwd_dev_ms / fwd_ms:.3f} card=\"{name_power}\"", flush=True)
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    for e in top[:8]:
        if e.self_device_time_total > 0:
            print(f"profile: forward {e.key[:60]} calls/fwd="
                  f"{e.count / REPS:g} device_ms/fwd="
                  f"{e.self_device_time_total / REPS / 1e3:.4f}", flush=True)

    req = list(np.random.default_rng(3).integers(
        0, 256, (64,) + net.input_shape[1:], dtype=np.uint8))
    rps = []
    for _ in range(3):
        with BatchServer(net, batch=cfg.batch,
                         input_shape=net.input_shape[1:]) as srv:
            t0 = time.perf_counter()
            for f in srv.submit_many(req):
                f.result(timeout=300)
            rps.append(len(req) / (time.perf_counter() - t0))
    print(f"timing: served requests/s={statistics.median(rps):.1f} "
          f"(median of 3 bursts of {len(req)}, batch {cfg.batch}) "
          f"card=\"{name_power}\"", flush=True)

    rows = []
    for k, (src, replaces, also) in KERNEL_INFO.items():
        row = {"name": k, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts[k],
               "max_abs_err": parity.err[k], "ms": round(per[k][0], 6),
               "plain_ms": round(per[k][1], 6),
               "device_ms": round(per[k][2], 6),
               "plain_device_ms": round(per[k][3], 6)}
        if also:
            row["also_replaces"] = also
        rows.append(row)
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA H100", file=sys.stderr)
        sys.exit(1)
    from deepfusion_tpu_torch.models import FusionNet, FusionNetConfig

    name_power = phase_device()
    phase_build()
    dev = torch.device("cuda:0")
    cfg = FusionNetConfig()
    net = FusionNet(cfg, device=dev)
    with torch.inference_mode():
        parity = phase_parity(net, dev)
    counts = phase_slice(net, cfg, dev)
    rows = phase_timings(net, cfg, dev, name_power, parity, counts)
    print(name_power)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
