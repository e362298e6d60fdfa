"""The kernels' times on one card: every kernel of the port at the models'
layers and at bench.py's shapes, warm and cold, beside its plain version,
its bound and, where one PyTorch call computes the same function, that call.

    python3 tools/kernel_times.py                  # this checkout
    python3 tools/kernel_times.py TREE [TREE ...]  # an A/B of trees

With trees (e.g. ``chip_checkout/parent .``: ``git archive`` of a commit
unpacked under chip_checkout/, which .gitignore lists), each tree runs in
its own process, which imports and builds that tree's package, in turns
(the trees in the order given, then back: ``oncard.run_trees``), and each
entry's median per tree is printed beside its ratio to the first tree's.
Without, this checkout runs once in this process and its lines are printed.

The entries, at FusionNet, ResFusionNet and VGGFusion at full width, batch
8, and at bench.py's shapes (``timing:`` lines; times in ms): K1a/K1b at
every dense layer with its plan (``conv_plan``) and its sums per model; K2
at FusionNet's branch merge, at 17 and 40 inputs and at the reference's
three s8 sets (batch 4), each beside ``torch.cat`` and per call in turns
with it; K3 at its four model launches, the max pool beside a 2x2 ``amax``;
K4 at FusionNet's residual; K5 at every packed layer with its plan, at the
C13 shapes (the join alone too) and at bench.py's default shape; FusionNet's
res with merge_pool at batch 8 and 256 beside the pair it replaced (the
res conv's full-resolution output, then K8) and the pool alone; K6 and K8
at FusionNet's residual and K8 at the C13 shapes; K7 at ResFusionNet's
downsample beside the 2x2 ``amax`` (also per call in turns); K9 beside K1
then K3; K10 at VGGFusion's blocks beside K5 + K5 with pool2 and K5 + K5 +
K7, and at bench.py's --pair shape; ResNet-50's 7x7/s2 stem at batch 8 and
256 as its launch runs it (the input's preparation and K1) and the
preparation alone (the unfold of its column taps, or in a tree without it
the pad to 16 channels); the depthwise kernel (DW) at MobileNetV2's 17
layers at batch 8 and 256 (none in a tree without it); bench.py's shapes
in TOP/s beside
``torch._int_mm`` at their GEMMs (``yardstick:``); the host microseconds
of each wrapper, of each part of a launch (K1, K7, K2) and of a
``_build.kernels()`` call after the first, of ``cuTensorMapEncodeTiled``,
and the empty kernel's floor (``host:``). Warm: inputs reused, so they may
sit in the L2; cold: a 128 MB read before every call
(``oncard.cold_device_ms``). The bound is the larger of the bytes moved
over 3.35 TB/s and the operations over 1,979 TOP/s int8 (67 T/s for
elementwise work); share = bound / cold. Last, one ``kernel:`` line per
row of PERF.md §6 (K1a-K10, DW): its sums over the launches one forward of
each model makes (DW: MobileNetV2's at batch 8), or over its timed cases
where no forward launches it.
"""
import importlib
import importlib.util
import os
import statistics
import sys
import time

import numpy as np
import torch

import oncard
from oncard import (bound_ms, cold_device_ms, conv_ops, cuda_ms, device_ms,
                    nbytes, packed_input, packed_reads, rand)

ROWS = ("K1a", "K1b", "K2", "K3", "K4", "K5", "K5 C13", "K5 merge-pool",
        "K6", "K7", "K8", "K9", "K10", "DW")
NAN = float("nan")


def host_us(fn, calls=200, loops=5):
    """Host microseconds per call of fn(): the median of `loops` loops of
    `calls` calls that the device keeps up with, no synchronisation inside
    a loop."""
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


class Run:
    """One run: its entries ({name: number}, what an A/B compares), its
    cases per PERF.md §6 row, K1's sums per model; each number printed
    with the card."""

    def __init__(self):
        self.card = oncard.card()
        self.res = {}
        self.rows = {r: [] for r in ROWS}
        self.groups = {g: [0.0, 0.0, 0.0, 0] for g in ("Fd", "Rd", "Vd",
                                                       "heads")}

    def out(self, line, **entries):
        self.res.update(entries)
        print(f"{line} card=\"{self.card}\"", flush=True)

    def timed(self, row, label, fn, plain, forward=True, reads=(), ops=0.0,
              tensor=True, library=None, group=None, host=False):
        """A kernel and its plain version, the kernel warm and cold; its
        bound from the bytes it must move (reads, each once, and its
        output) and its operations; the library call warm and cold where
        there is one; the wrapper's host us where asked. `forward`: one
        forward of a model at batch 8 launches it."""
        t = (cuda_ms(fn), cuda_ms(plain), device_ms(fn), device_ms(plain))
        cold = cold_device_ms(fn)
        nb = nbytes(reads, fn())
        b_ms, b_by = bound_ms(nb, ops, tensor)
        lib = (NAN,) * 3 if library is None else (
            cuda_ms(library), device_ms(library), cold_device_ms(library))
        key = f"{row} {label}"
        ent = {key: t[2], f"{key} cold": cold}
        if library is not None:
            ent[f"{key} library"] = lib[1]
        if host:
            ent[f"{key} host us"] = host_us(fn)
        self.rows[row].append((forward, t[2], cold, t[3], b_ms, t[0], t[1],
                               lib[1]))
        if group is not None:
            for i, v in enumerate((t[2], cold, b_ms, 1)):
                self.groups[group][i] += v
        self.out(f"timing: {key} ms={t[0]:.4f} plain_ms={t[1]:.4f} "
                 f"device_ms={t[2]:.5f} cold_device_ms={cold:.5f} "
                 f"plain_device_ms={t[3]:.4f} bound_ms={b_ms:.5f} "
                 f"bound_by={b_by} bytes={nb} ops={ops:.4g} "
                 f"cold_share={b_ms / cold:.4f} library_ms={lib[0]:.4f} "
                 f"library_device_ms={lib[1]:.5f} library_cold_device_ms="
                 f"{lib[2]:.5f}" + (f" host_us={ent[f'{key} host us']:.2f}"
                                    if host else ""), **ent)

    def in_turns(self, label, fns, rounds=2):
        """Per-call CUDA-event ms of each fn in `fns` ({name: fn}):
        medians of 20 calls, taken in turns (A, B, B, A per round); the
        mean per fn."""
        ms = {k: [] for k in fns}
        for _ in range(rounds):
            for k in list(fns) + list(fns)[::-1]:
                ms[k].append(cuda_ms(fns[k]))
        ent = {f"{label} per call {k} ms": statistics.mean(v)
               for k, v in ms.items()}
        self.out(f"timing: {label} per call in turns " + " ".join(
            f"{k.replace(' ', '_')}_ms={statistics.mean(v):.4f}"
            for k, v in ms.items()), **ent)

    def host_parts(self, kernel, parts, calls=2000):
        """Host microseconds of each part of one launch (`parts`: {label:
        fn}), each alone in a loop of `calls` calls that the device keeps
        up with, no synchronisation inside the loop."""
        for label, fn in parts.items():
            us = host_us(fn, calls=calls, loops=1)
            self.out(f"host: {kernel} launch part {label} {us:.3f} us per "
                     f"call (mean of {calls})",
                     **{f"{kernel} launch part {label} host us": us})

    def summary(self):
        """One line per PERF.md §6 row, its sums over the launches one
        forward of each model makes (over its timed cases where no
        forward launches it)."""
        for row in ROWS:
            cases = self.rows[row]
            if not cases:        # a kernel this tree lacks
                continue
            fw = [c for c in cases if c[0]]
            s = [sum(c[i] for c in fw or cases) for i in range(1, 8)]
            what = (f"{len(fw)} launches of the forwards" if fw else
                    f"its {len(cases)} timed cases (no forward launches it)")
            self.res[f"{row} sum"] = s[0]
            self.res[f"{row} sum cold"] = s[1]
            self.out(f"kernel: {row} over {what}: device_ms={s[0]:.5f} "
                     f"cold_device_ms={s[1]:.5f} plain_device_ms={s[2]:.4f} "
                     f"bound_ms={s[3]:.5f} cold_share={s[3] / s[1]:.4f} "
                     f"ms={s[4]:.4f} plain_ms={s[5]:.4f} "
                     f"library_device_ms={s[6]:.5f}")


def print_plan(kind, label, p):
    """A kernel's plan (``conv_plan``, ``convpool_plan``,
    ``packed_conv_plan``, ``pair_conv_plan``), key for key."""
    print(f"plan: {kind} {label} " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in p.items()), flush=True)


def k1_host_parts(run, conv_op, x):
    """Host microseconds of the parts of K1's launch by the ConvOp
    `conv_op` on `x`: the op's lookup, the kept weight maps, the registered
    op alone, the whole wrapper (conv_cuda) and the module's call (its
    checks, then the wrapper)."""
    from deepfusion_tpu_torch import _build
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    op = _build.op("conv_fused")
    c = conv_op.cfg
    fuse = c.fuse_conv1x1
    args = (x, K._weight_maps(conv_op), conv_op.bias0, conv_op.scale0,
            conv_op.bias1 if fuse else None,
            conv_op.scale1 if fuse else None, None, conv_op._geo,
            c.sum_scale, False)
    run.host_parts("K1", {
        "_build.op lookup": lambda: _build.op("conv_fused"),
        "_weight_maps (kept per op)": lambda: K._weight_maps(conv_op),
        "the op (torch.ops overload: checks, allocation, launch)":
            lambda: op(*args),
        "conv_cuda (the whole wrapper)": lambda: K.conv_cuda(conv_op, x),
        "ConvOp call (checks and wrapper)": lambda: conv_op(x)})


def k7_host_parts(run, y, spec):
    """Host microseconds of the parts of K7's launch on the packed array
    `y` (its spec `spec`): the op's lookup, the registered op alone (its
    checks, alignment, allocation, device guard, stream and launch in C++),
    the whole wrapper, and the functional op with its checks; beside them
    torch.empty of the output (one allocation through PyTorch's own
    binding)."""
    from deepfusion_tpu_torch import _build
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    rows, iwp = spec.rows, spec.iwp
    op = _build.op("packed_sum_pool")
    shape = (y.shape[0], rows // 2 * (iwp // 2), spec.cp)
    run.host_parts("K7", {
        "_build.op lookup": lambda: _build.op("packed_sum_pool"),
        "torch.empty (the output)": lambda: torch.empty(
            shape, dtype=torch.int8, device=y.device),
        "the op (torch.ops overload: checks, allocation, launch)":
            lambda: op([y], None, rows, iwp, True),
        "packed_sum_pool_cuda (the whole wrapper)":
            lambda: PK.packed_sum_pool_cuda([y], None, True, rows, iwp),
        "packed_maxpool2 (the op: checks and wrapper)":
            lambda: PK.packed_maxpool2(y, spec)})


def k2_host_calls(run, shape, dev, calls=400, rounds=5):
    """Host microseconds of K2's call through its registered op at the
    branch merge's inputs (two u8 tensors of `shape`, made outside
    inference mode), without and with torch.inference_mode (the Autograd
    key's fallthrough): each part in a loop of `calls` calls (the device
    keeps up), the parts in turns, `rounds` rounds; the median and the
    least loop. The parts: the op's overload alone, concat_cuda (the op and
    the launch count), concat() (its kept config, the per-tensor checks,
    the choice of path); and beside them torch.cat on the same inputs,
    the same ATen cat through the same torch.ops path as the op
    (torch.ops.aten.cat.default: what that path costs a native op) and
    torch.empty of the output (one allocation through PyTorch's own
    binding). Then, under inference mode, torch.profiler's host events per
    call of the op and of torch.cat (self CPU us; the profiler's own cost
    included)."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.config import ConcatConfig
    from deepfusion_tpu_torch.types import dtype
    C = importlib.import_module("deepfusion_tpu_torch.ops.concat")
    with torch.inference_mode(False):
        rng = np.random.default_rng(10)
        xs = [rand(rng, shape, dtype.u8, dev) for _ in range(2)]
    cfg = ConcatConfig.make([shape] * 2, dtype.u8, True)
    op = _build.op("concat_relu")
    out_shape = shape[:3] + (2 * shape[3],)
    parts = {
        "the op (torch.ops overload)": lambda: op(xs, True),
        "concat_cuda (op and count)": lambda: C.concat_cuda(xs, cfg),
        "concat() (kept config)": lambda: C.concat(xs, post_relu=True),
        "torch.cat": lambda: torch.cat(xs, dim=-1),
        "torch.ops.aten.cat.default": lambda: torch.ops.aten.cat.default(
            xs, -1),
        "torch.empty (the output)": lambda: torch.empty(
            out_shape, dtype=torch.uint8, device=dev),
    }
    for mode in (False, True):
        with torch.inference_mode(mode):
            us = {k: [] for k in parts}
            for fn in parts.values():
                fn()
            torch.cuda.synchronize()
            for _ in range(rounds):
                for label, fn in parts.items():
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    us[label].append((time.perf_counter() - t0) / calls * 1e6)
                    torch.cuda.synchronize()
            for label, v in us.items():
                med = statistics.median(v)
                run.out(f"host: K2 call {label} inference_mode={mode} "
                        f"{med:.3f} us per call (median of {rounds} loops of "
                        f"{calls} in turns; least {min(v):.3f})", **{
                            f"K2 call {label} inference_mode={mode} host us":
                                med})
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for label in ("the op (torch.ops overload)", "torch.cat"):
            fn = parts[label]
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            for e in sorted(prof.key_averages(),
                            key=lambda e: -e.self_cpu_time_total)[:6]:
                run.out(f"host: K2 call {label} profile {e.key[:48]} "
                        f"calls/call={e.count / calls:g} self_cpu_us/call="
                        f"{e.self_cpu_time_total / calls:.3f} cpu_us/call="
                        f"{e.cpu_time_total / calls:.3f}")


def encode_host_us(run, arr, spec, calls=2000):
    """Host microseconds of one cuTensorMapEncodeTiled, the call the packed
    conv's launcher makes for each input box width at every launch: a
    128-lane box of 16 x 8 pixels of the packed array `arr` (its spec
    `spec`), 128-byte swizzle, called through the driver library here to
    time it alone."""
    import ctypes
    fn = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    dims = (u64 * 4)(spec.cp, spec.iwp, spec.rows, arr.shape[0])
    strides = (u64 * 3)(spec.cp, spec.cp * spec.iwp,
                        spec.cp * spec.iwp * spec.rows)
    box, ones = (u32 * 4)(128, 8, 16, 1), (u32 * 4)(1, 1, 1, 1)
    out = (ctypes.c_uint8 * 128)()
    # UINT8, rank 4, no interleave, 128-byte swizzle, 128-byte L2
    # promotion, no NaN fill: the launcher's arguments
    args = (out, 0, 4, ctypes.c_void_p(arr.data_ptr()), dims, strides, box,
            ones, 0, 3, 2, 0)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"cuTensorMapEncodeTiled returned {rc}")
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    us = (time.perf_counter() - t0) / calls * 1e6
    run.out(f"host: cuTensorMapEncodeTiled {us:.3f} us per map (mean of "
            f"{calls} calls, through ctypes)",
            **{"cuTensorMapEncodeTiled host us": us})


def int_mm_yardstick(run, label="bench.py default layer", m=8 * 126 * 126,
                     gemms=((9 * 256, 256), (256, 256))):
    """torch._int_mm at a fused layer's GEMM shapes (by default bench.py's
    default layer, 8x126x126 pixels: the im2col'd 3x3, K = 9 x 256, then
    the 1x1, K = 256; both N = 256), A built outside the timed call: what
    the card's own int8 GEMM does with the layer's multiply-adds. A
    yardstick only: it is not the same function (no im2col, no requant, no
    fusion)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    total, macs = 0.0, 0
    for k, n in gemms:
        a = torch.randint(-128, 128, (m, k), dtype=torch.int8, device="cuda",
                          generator=g)
        b = torch.randint(-128, 128, (n, k), dtype=torch.int8,
                          device="cuda", generator=g).t()
        d = device_ms(lambda: torch._int_mm(a, b), profiles=3)
        total += d
        macs += m * k * n
        run.out(f"yardstick: {label} torch._int_mm {m}x{k}x{n} device_ms="
                f"{d:.4f} device_TOPs={2 * m * k * n / d / 1e9:.1f}")
        del a, b
    run.out(f"yardstick: {label} torch._int_mm both GEMMs device_ms="
            f"{total:.4f} device_TOPs={2 * macs / total / 1e9:.1f}",
            **{f"torch._int_mm {label}": total})


def bench_shape(run, row, label, fn, macs):
    """A kernel at one of bench.py's shapes: per call, warm and cold
    device ms, TOP/s and the share of the int8 peak."""
    ms, dev = cuda_ms(fn), device_ms(fn, profiles=3)
    cold = cold_device_ms(fn)
    tops = 2 * macs / (dev * 1e-3) / 1e12
    run.out(f"timing: {row} {label} ms={ms:.4f} device_ms={dev:.4f} "
            f"cold_device_ms={cold:.4f} device_TOPs={tops:.1f} "
            f"cold_device_TOPs={2 * macs / cold / 1e9:.1f} share_of_int8_peak="
            f"{tops / oncard.H100_INT8_PEAK_TOPS:.4f}",
            **{f"{row} {label}": dev, f"{row} {label} cold": cold})


def fusionnet_times(run, net, dev):
    """FusionNet's dense and packed kernels, K2's and K8's other cases,
    the C13 shapes, the empty kernel."""
    from deepfusion_tpu_torch.config import ConcatConfig, PoolConfig
    from deepfusion_tpu_torch.models.fusionnet import LAYERS
    from deepfusion_tpu_torch.ops.conv import conv_plan
    from deepfusion_tpu_torch.ops.packed import packed_conv_plan
    from deepfusion_tpu_torch.types import dtype
    C = importlib.import_module("deepfusion_tpu_torch.ops.concat")
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    rng = np.random.default_rng(9)
    u8 = dtype.u8
    for name in LAYERS:
        op = getattr(net, name)
        c = op.cfg
        x = rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
        print_plan("conv_fused", f"FusionNet {name}", conv_plan(op, c.bs))
        if name == "stem":
            k1_host_parts(run, op, x)
        run.timed("K1b" if c.fuse_conv1x1 else "K1a", f"FusionNet {name}",
                  lambda: K.conv_cuda(op, x), lambda: K.conv_plain(op, x),
                  reads=(x, op), ops=conv_ops(c),
                  group="Fd" if name != "head" else "heads",
                  host=name in ("stem", "block2"))
    n, hw, w = net.cfg.batch, net.cfg.hw, net.cfg.width
    xs = [rand(rng, (n, hw, hw, w), u8, dev) for _ in range(2)]
    ccfg = ConcatConfig.make([tuple(x.shape) for x in xs], u8, True)
    run.timed("K2", "branch merge", lambda: C.concat_cuda(xs, ccfg),
              lambda: C.concat_plain(xs, ccfg), reads=xs, tensor=False,
              library=lambda: torch.cat(xs, dim=-1), host=True)
    run.in_turns("K2 branch merge", {
        "kernel": lambda: C.concat_cuda(xs, ccfg),
        "torch.cat": lambda: torch.cat(xs, dim=-1)})
    k2_host_calls(run, (n, hw, hw, w), dev)
    # many narrow inputs (one launch each), then the reference's three s8
    # sets at batch 4 (bench.py --op concat; torch.cat beside them does no
    # ReLU; the 9x9 set's bound is a few ns: it times a launch)
    many = [(f"{n_in} inputs (1 launch per call)", u8,
             [(n, hw, hw, 16 * (1 + i % 3)) for i in range(n_in)])
            for n_in in (17, 40)]
    many += [(f"reference {s}x{s} s8 batch 4", dtype.s8,
              [(4, s, s, c) for c in chans])
             for s, chans in oncard.CONCAT_SETS.items()]
    for label, dt_m, shapes in many:
        xs_m = [rand(rng, s, dt_m, dev) for s in shapes]
        cfg_m = ConcatConfig.make(shapes, dt_m, True)
        run.timed("K2", label, lambda: C.concat_cuda(xs_m, cfg_m),
                  lambda: C.concat_plain(xs_m, cfg_m), forward=False,
                  reads=xs_m, tensor=False,
                  library=lambda: torch.cat(xs_m, dim=-1))
        run.in_turns(f"K2 {label}", {
            "kernel": lambda: C.concat_cuda(xs_m, cfg_m),
            "torch.cat": lambda: torch.cat(xs_m, dim=-1)})
    del xs_m
    y = rand(rng, (n, hw, hw, 2 * w), u8, dev)
    r = rand(rng, (n, hw, hw, 2 * w), u8, dev)
    run.timed("K4", "FusionNet residual", lambda: P.sum_relu_cuda(y, r, u8,
                                                                  True),
              lambda: P.sum_relu_plain(y, r, u8, True), reads=(y, r),
              ops=y.numel(), tensor=False, host=True)
    pc = PoolConfig.make("max", (hw, hw), (2, 2), (2, 2), (0, 0))
    run.timed("K3", "FusionNet maxpool 2x2/s2", lambda: P.pool_cuda(y, pc, u8),
              lambda: P.pool_plain(y, pc, u8), reads=(y,), ops=y.numel(),
              tensor=False, host=True, library=lambda: y.reshape(
                  n, hw // 2, 2, hw // 2, 2, 2 * w).amax(dim=(2, 4)))
    h2 = hw // 2
    z = rand(rng, (n, h2, h2, w), u8, dev)
    pc2 = PoolConfig.make("avg_exc", (h2, h2), (h2, h2), (h2, h2), (0, 0))
    run.timed("K3", "FusionNet global avg_exc",
              lambda: P.pool_cuda(z, pc2, u8),
              lambda: P.pool_plain(z, pc2, u8), reads=(z,), ops=z.numel(),
              tensor=False)

    # the packed path's kernels at its shapes (its head is K1, above)
    packed = net.build_packed()
    for name, op in packed.items():
        arrs = [packed_input(rng, s, n, dev) for s in op.sins]
        print_plan("packed_conv", f"FusionNet {name}", packed_conv_plan(op, n))
        run.timed("K5 merge-pool" if op.merge_pool else "K5",
                  f"FusionNet {name}", lambda: PK.packed_conv_cuda(op, arrs),
                  lambda: PK.packed_conv_plain(op, arrs),
                  reads=(packed_reads(op, n), op),
                  ops=conv_ops(op.cfg_orig or op.cfg, n),
                  host=name in ("stem", "res"))
    rs = packed["res"].sout
    ys = [packed_input(rng, s, n, dev)
          for s in (packed["block1"].sout, packed["branch"].sout)]
    rr = packed_input(rng, rs, n, dev)
    run.timed("K8", "FusionNet residual sum+pool",
              lambda: PK.packed_sum_pool_cuda(ys, rr, True, rs.rows, rs.iwp),
              lambda: PK.packed_sum_pool_plain(ys, rr, True, rs.rows, rs.iwp),
              forward=False, reads=(ys, rr), ops=2 * rr.numel(),
              tensor=False)
    merge_pool_times(run, net, dev)
    y2 = torch.cat(ys, dim=-1)
    for row, label, args, reads in (
            ("K6", "FusionNet residual sum only", ([y2], rr, False),
             (y2, rr)),
            ("K7", "FusionNet residual pool only", ([y2], None, True),
             (y2,))):
        run.timed(row, label,
                  lambda: PK.packed_sum_pool_cuda(*args, rs.rows, rs.iwp),
                  lambda: PK.packed_sum_pool_plain(*args, rs.rows, rs.iwp),
                  forward=False, reads=reads,
                  ops=rr.numel() // (4 if args[2] else 1), tensor=False)

    # C13 at FusionNet's size: the packed conv's join of its inputs
    # (kernel_groups) and the kernel, against the bound of the unjoined
    # inputs (at 28x28 the bounds are under 1 us: only chip_smoke.py's
    # parity runs there); then the packed sum/pool, its inputs as they are
    crng = np.random.default_rng(12)
    for label, hw_c, cs, oc, _, kw in oncard.C13_CONVS:
        op = oncard.packed_conv_op(crng, hw_c, cs, oc, dev=dev, n=8, **kw)
        arrs = [packed_input(rng, s, 8, dev) for s in op.sins]
        print(f"timing: K5 C13 {label}: inputs of {[s.cp for s in op.sins]} "
              f"lanes, the kernel's of {[s.cp for s in op.kernel_sins]}",
              flush=True)
        run.timed("K5 C13", f"{label} (join + kernel)",
                  lambda: PK.packed_conv_cuda(op, arrs),
                  lambda: PK.packed_conv_plain(op, arrs), forward=False,
                  reads=(packed_reads(op, 8), op), ops=conv_ops(op.cfg, 8))

        def join():
            return PK.join_groups(arrs, op.kernel_groups)
        j_ms, j_dev = cuda_ms(join), device_ms(join)
        run.out(f"timing: K5 C13 {label} the join alone ms={j_ms:.4f} "
                f"device_ms={j_dev:.4f}",
                **{f"K5 C13 {label} the join alone": j_dev})
    for label, ys_s, rs, bn in oncard.c13_sum_pool_cases():
        if not label.startswith("C13 56x56"):
            continue
        ys = [packed_input(rng, s, bn, dev) for s in ys_s]
        rr = packed_input(rng, rs, bn, dev)
        run.timed("K8", f"{label} sum+pool",
                  lambda: PK.packed_sum_pool_cuda(ys, rr, True, rs.rows,
                                                  rs.iwp),
                  lambda: PK.packed_sum_pool_plain(ys, rr, True, rs.rows,
                                                   rs.iwp), forward=False,
                  reads=(ys, rr), ops=2 * rr.numel(), tensor=False)
    empty_kernel_floor(run)


def merge_pool_times(run, net, dev, batches=(8, 256)):
    """FusionNet's residual conv with the merge and pool in its epilogue
    (K5 merge_pool, one launch) against the pair it replaced, the conv
    writing the full-resolution residual and K8 summing and pooling it, and
    against the same conv with the pool alone (the merge's floor), at batch
    8 and 256: each part's device ms warm and cold and its bound (bytes:
    the inputs read once, the output written)."""
    from deepfusion_tpu_torch.ops.packed import PackedConvOp
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    rng = np.random.default_rng(19)
    res = net.build_packed()["res"]
    p = net.params["res"]
    old = PackedConvOp(res.cfg, p["wei"], p["bia"], sin=res.sins,
                       col_off_out=res.sout.col_off,
                       halo_out=res.sout.halo, device=dev)
    floor = PackedConvOp(res.cfg, p["wei"], p["bia"], sin=res.sins,
                         col_off_out=res.sout.col_off,
                         halo_out=res.sout.halo, pool2=True, device=dev)
    rs = old.sout
    for bn in batches:
        xs = [packed_input(rng, s, bn, dev) for s in res.sins]
        r = PK.packed_conv_cuda(old, xs)

        def k8(r):
            return PK.packed_sum_pool_cuda(xs, r, True, rs.rows, rs.iwp)
        parts = {
            "merge_pool (one launch)": (
                lambda: PK.packed_conv_cuda(res, xs),
                (packed_reads(res, bn),)),
            "res conv with the pool alone (no merge)": (
                lambda: PK.packed_conv_cuda(floor, xs),
                (packed_reads(floor, bn),)),
            "res conv, full-resolution output": (
                lambda: PK.packed_conv_cuda(old, xs),
                (packed_reads(old, bn),)),
            "K8 sum+pool": (lambda: k8(r), (xs, r)),
            "res conv + K8 (the pair replaced)": (
                lambda: k8(PK.packed_conv_cuda(old, xs)),
                (packed_reads(old, bn), 2 * r.numel(), xs))}
        ops = conv_ops(res.cfg, bn)
        for label, (fn, reads) in parts.items():
            warm, cold = device_ms(fn, profiles=3), cold_device_ms(fn)
            b_ms, b_by = bound_ms(nbytes(reads, fn()),
                                  0 if label.startswith("K8") else ops)
            key = f"K5 merge-pool FusionNet res batch {bn}: {label}"
            run.out(f"timing: {key} device_ms={warm:.5f} cold_device_ms="
                    f"{cold:.5f} bound_ms={b_ms:.5f} bound_by={b_by} "
                    f"cold_share={b_ms / cold:.4f}",
                    **{key: warm, f"{key} cold": cold})
        del xs, r


def empty_kernel_floor(run, calls=1000):
    """The floor of a launch on this card: a kernel that does nothing
    (csrc/empty.cu) launched `calls` times through its registered op from
    Python, one launch a call, then once with `calls` launches made back to
    back by the op's C++ loop ("raw": no Python, no dispatcher between
    launches); CUDA events around each loop, warm, the median of 3 loops;
    beside them torch.profiler's device time of one empty kernel."""
    from deepfusion_tpu_torch import _build
    op = _build.op("empty_launches")
    loops = {"through the op": lambda: [op(1) for _ in range(calls)],
             "raw": lambda: op(calls)}
    for label, fn in loops.items():
        ms = cuda_ms(fn, reps=3, warmup=1) / calls
        run.out(f"host: empty kernel {label} ms={ms:.5f} per launch (median "
                f"of 3 loops of {calls}, CUDA events)",
                **{f"empty kernel {label} per launch": ms})
    d = device_ms(lambda: op(1), reps=calls)
    run.out(f"host: empty kernel device_ms={d:.5f} per launch "
            "(torch.profiler)", **{"empty kernel device": d})


def resfusion_times(run, rnet, dev):
    """ResFusionNet: K9 at the downsample beside K1 then K3, its other
    layers' kernels, K3's global average, K7 beside the 2x2 amax."""
    from deepfusion_tpu_torch.config import PoolConfig
    from deepfusion_tpu_torch.ops.conv import conv_plan
    from deepfusion_tpu_torch.ops.packed import packed_conv_plan
    from deepfusion_tpu_torch.types import dtype
    CP = importlib.import_module("deepfusion_tpu_torch.ops.convpool")
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    rng = np.random.default_rng(10)
    u8 = dtype.u8
    n = rnet.cfg.batch
    k9_beside_k1_k3(run, "ResFusionNet down", rnet.down, rnet.params["down"],
                    rng, dev)
    for name in ("stem", "block1", "block2", "head"):
        op = getattr(rnet, name)
        c = op.cfg
        xi = rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
        sm = rand(rng, (c.bs, c.oh, c.ow, c.out_oc), u8, dev) \
            if c.with_sum else None
        print_plan("conv_fused", f"ResFusionNet {name}", conv_plan(op, c.bs))
        run.timed("K1b" if c.fuse_conv1x1 else "K1a", f"ResFusionNet {name}",
                  lambda: K.conv_cuda(op, xi, sm),
                  lambda: K.conv_plain(op, xi, sm), reads=(xi, sm, op),
                  ops=conv_ops(c), group="Rd" if name != "head" else "heads")
    for name, op in rnet.build_packed().items():
        arrs = [packed_input(rng, s, n, dev) for s in op.sins]
        sm = None if op.ssum is None else packed_input(rng, op.ssum, n, dev)
        print_plan("packed_conv", f"ResFusionNet {name}",
                   packed_conv_plan(op, n))
        run.timed("K5", f"ResFusionNet {name}",
                  lambda: PK.packed_conv_cuda(op, arrs, sm),
                  lambda: PK.packed_conv_plain(op, arrs, sm),
                  reads=(packed_reads(op, n), op),
                  ops=conv_ops(op.cfg_orig or op.cfg, n))
    c = rnet.block2.cfg
    z = rand(rng, (c.bs, c.oh, c.ow, c.out_oc), u8, dev)
    pg = PoolConfig.make("avg_exc", (c.oh, c.ow), (c.oh, c.ow), (c.oh, c.ow),
                         (0, 0))
    run.timed("K3", "ResFusionNet global avg_exc",
              lambda: P.pool_cuda(z, pg, u8), lambda: P.pool_plain(z, pg, u8),
              reads=(z,), ops=z.numel(), tensor=False)
    # K7, the packed max pool after the downsample, against a 2x2 amax of
    # the packed image's interior view (stored bytes order as u8 does)
    ds = rnet.build_packed()["down"].sout
    y = packed_input(rng, ds, n, dev)
    inner = y.view(n, ds.rows, ds.iwp, ds.cp)[
        :, ds.halo:ds.halo + ds.h, ds.col_off:ds.col_off + ds.w]

    def amax():
        return inner.unflatten(1, (ds.h // 2, 2)).unflatten(
            3, (ds.w // 2, 2)).amax(dim=(2, 4))

    def k7():
        return PK.packed_sum_pool_cuda([y], None, True, ds.rows, ds.iwp)
    run.timed("K7", "ResFusionNet down pool only", k7,
              lambda: PK.packed_sum_pool_plain([y], None, True, ds.rows,
                                               ds.iwp),
              reads=(n * ds.h * ds.w * ds.cp,), ops=n * ds.h * ds.w * ds.cp,
              tensor=False, library=amax, host=True)
    run.in_turns("K7 ResFusionNet down pool only",
                 {"kernel": k7, "2x2 amax": amax})
    k7_host_parts(run, y, ds)


def k9_beside_k1_k3(run, label, op, params, rng, dev):
    """K9 at a conv+pool layer (with its plan), then the same layer as two
    kernels: K1's u8 output through memory, then K3's 2x2 max pool."""
    from deepfusion_tpu_torch.ops.convpool import convpool_plan
    from deepfusion_tpu_torch.types import dtype
    CP = importlib.import_module("deepfusion_tpu_torch.ops.convpool")
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    c = op.cfg
    x = rand(rng, (c.bs, c.ih, c.iw, c.ic), dtype.u8, dev)
    print_plan("convpool", label, convpool_plan(op, c.bs))
    run.timed("K9", label, lambda: CP.convpool_cuda(op, x),
              lambda: CP.convpool_plain(op, x), reads=(x, op), ops=conv_ops(c),
              host=label == "ResFusionNet down")
    cop = K.ConvOp(c, params["wei"], params.get("bia"), device=dev)

    def composed():
        return P.pool_cuda(K.conv_cuda(cop, x), op.pc, dtype.u8)
    ms, warm = cuda_ms(composed), device_ms(composed, profiles=3)
    cold = cold_device_ms(composed)
    key = f"K1 + K3 {label}"
    run.out(f"timing: {key} ms={ms:.4f} device_ms={warm:.4f} "
            f"cold_device_ms={cold:.4f}", **{key: warm, f"{key} cold": cold})


def vggfusion_times(run, vnet, dev):
    """VGGFusion: K1 at the conv1s and the head, K9 beside K1 then K3, K10
    per block beside the same block as separate packed kernels, K3's
    global average."""
    from deepfusion_tpu_torch.config import PoolConfig
    from deepfusion_tpu_torch.ops.conv import conv_plan
    from deepfusion_tpu_torch.ops.mega import pair_conv_plan
    from deepfusion_tpu_torch.ops.packed import PackedConvOp, packed_conv_plan
    from deepfusion_tpu_torch.types import dtype
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    M = importlib.import_module("deepfusion_tpu_torch.ops.mega")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    rng = np.random.default_rng(16)
    n = vnet.cfg.batch
    for name, op in [(f"block{b}_conv1", op)
                     for b, op in enumerate(vnet.conv1, 1)] + [
                         ("head", vnet.head)]:
        c = op.cfg
        xi = rand(rng, (c.bs, c.ih, c.iw, c.ic), dtype.u8, dev)
        print_plan("conv_fused", f"VGGFusion {name}", conv_plan(op, c.bs))
        run.timed("K1b" if c.fuse_conv1x1 else "K1a", f"VGGFusion {name}",
                  lambda: K.conv_cuda(op, xi), lambda: K.conv_plain(op, xi),
                  reads=(xi, op), ops=conv_ops(c),
                  group="Vd" if name != "head" else "heads")
    for b, op in enumerate(vnet.convpool2, 1):
        k9_beside_k1_k3(run, f"VGGFusion block{b} conv2+pool", op,
                        vnet.params[f"block{b}_conv2"], rng, dev)
    for b, pair in enumerate(vnet.build_packed(), 1):
        print_plan("pair_conv", f"VGGFusion block{b}", pair_conv_plan(pair, n))
        x = packed_input(rng, pair.sin, n, dev)
        run.timed("K10", f"VGGFusion block{b}",
                  lambda: M.pair_conv_cuda(pair, x),
                  lambda: M.pair_conv_plain(pair, x),
                  reads=(packed_reads(pair.op_a, n), pair),
                  ops=conv_ops(pair.cfg_a, n) + conv_ops(pair.cfg_b, n),
                  host=b == 1)
        p2 = vnet.params[f"block{b}_conv2"]
        op_b = PackedConvOp(pair.cfg_b, p2["wei"], p2.get("bia"),
                            sin=pair.op_b.sin, col_off_out=pair.sout.col_off,
                            halo_out=pair.sout.halo, device=dev)

        def three():
            y = PK.packed_conv_cuda(op_b, [PK.packed_conv_cuda(pair.op_a,
                                                                [x])])
            return PK.packed_maxpool2(y, pair.sout)[0]

        def two():
            return PK.packed_conv_cuda(pair.op_b, [PK.packed_conv_cuda(
                pair.op_a, [x])])
        mid = PK.packed_conv_cuda(pair.op_a, [x])
        print_plan("packed_conv", f"VGGFusion block{b} conv b with pool2",
                   packed_conv_plan(pair.op_b, n))
        run.timed("K5", f"VGGFusion block{b} conv b with pool2",
                  lambda: PK.packed_conv_cuda(pair.op_b, [mid]),
                  lambda: PK.packed_conv_plain(pair.op_b, [mid]),
                  forward=False, reads=(packed_reads(pair.op_b, n), pair.op_b),
                  ops=conv_ops(pair.cfg_b, n))
        for label, fn in (("K5 + K5 + K7", three), ("K5 + K5 pool2", two)):
            key = f"{label} VGGFusion block{b}"
            ms, warm, cold = cuda_ms(fn), device_ms(fn), cold_device_ms(fn)
            run.out(f"timing: {key} ms={ms:.4f} device_ms={warm:.4f} "
                    f"cold_device_ms={cold:.4f}",
                    **{key: warm, f"{key} cold": cold})
    v = vnet.convpool2[-1].cfg
    z = rand(rng, (v.bs, v.oh // 2, v.ow // 2, v.out_oc), dtype.u8, dev)
    pg = PoolConfig.make("avg_exc", z.shape[1:3], z.shape[1:3], z.shape[1:3],
                         (0, 0))
    run.timed("K3", "VGGFusion global avg_exc",
              lambda: P.pool_cuda(z, pg, dtype.u8),
              lambda: P.pool_plain(z, pg, dtype.u8), reads=(z,),
              ops=z.numel(), tensor=False)


def resnet50_stem_times(run, dev, batches=(8, 256)):
    """ResNet-50's stem (7x7/s2/p3 over 3 channels, 224 -> 112) at each
    batch: its launch as ``conv_cuda`` makes it (the input prepared for K1,
    then K1) beside the plain conv, and the preparation alone: the unfold
    of the seven column taps into 32 channels, or in a tree that lacks it
    (``ops/conv.py`` without ``unfold_cols``) the pad to 16 channels, under
    one entry name either way, so that trees compare. Both bounds count the
    image read once and the output written once."""
    from deepfusion_tpu_torch.models import ResNet50, ResNet50Config
    from deepfusion_tpu_torch.ops.conv import conv_plan
    from deepfusion_tpu_torch.types import dtype
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    rng = np.random.default_rng(50)
    stem = ResNet50(ResNet50Config(), device=dev).convs["stem"]
    c = stem.cfg
    unfold = hasattr(K, "unfold_cols") and K.unfold_cols(c)
    prep = "unfold" if unfold else "pad"
    for n in batches:
        x = rand(rng, (n, c.ih, c.iw, c.ic), dtype.u8, dev)
        label = f"ResNet50 stem b{n}"
        print_plan("conv_fused", label, conv_plan(stem, n))
        run.timed("K1a", f"{label} (prep + K1)",
                  lambda: K.conv_cuda(stem, x),
                  lambda: K.conv_plain(stem, x), forward=False,
                  reads=(x, stem), ops=conv_ops(c, n))
        if unfold:
            def prepare():
                return K._kernel_src(c, x, True)
        else:
            def prepare():
                return K._kernel_src(c, x)
        b_ms, b_by = bound_ms(nbytes(x, prepare()), 0.0, False)
        warm, cold = device_ms(prepare), cold_device_ms(prepare)
        key = f"{label} prep alone"
        run.out(f"timing: {key} ({prep}) device_ms={warm:.5f} cold_device_ms="
                f"{cold:.5f} bound_ms={b_ms:.5f} bound_by={b_by} "
                f"cold_share={b_ms / cold:.4f}",
                **{key: warm, f"{key} cold": cold})
        del x


def depthwise_times(run, dev, batches=(8, 256)):
    """The depthwise kernel at each of MobileNetV2's 17 layers (3x3 at
    stride 1 or 2 over 32-960 channels, 112x112 to 7x7) at each batch,
    beside its plain version; its bound counts the input and output once,
    the weights, bias and scale, and its nine multiply-adds an output on
    the CUDA cores. Nothing in a tree without the kernel."""
    if importlib.util.find_spec("deepfusion_tpu_torch.ops.depthwise") is None:
        return
    from deepfusion_tpu_torch.models import MobileNetV2, MobileNetV2Config
    from deepfusion_tpu_torch.types import dtype
    D = importlib.import_module("deepfusion_tpu_torch.ops.depthwise")
    rng = np.random.default_rng(1801)
    net = MobileNetV2(MobileNetV2Config(), device=dev)
    for n in batches:
        for layer in net.plan:
            if layer.kind != "depthwise":
                continue
            op = net.ops[layer.name]
            c = op.cfg
            x = rand(rng, (n, c.ih, c.iw, c.c), dtype.u8, dev)
            run.timed("DW", f"MobileNetV2 {layer.name} {c.ih}x{c.iw}x{c.c} "
                      f"s{c.stride} b{n}", lambda: D.depthwise_cuda(op, x),
                      lambda: D.depthwise_plain(op, x), forward=n == 8,
                      reads=(x, op), ops=18.0 * n * c.oh * c.ow * c.c,
                      tensor=False)
            del x


def bench_times(run, net, dev):
    """bench.py's default (K5), --dense (K1) and --pair (K10) shapes in
    TOP/s, torch._int_mm at their GEMMs and at FusionNet's fused blocks'
    im2col GEMMs (K1's yardstick)."""
    from deepfusion_tpu_torch.ops.conv import conv_plan
    from deepfusion_tpu_torch.ops.mega import pair_conv_plan
    from deepfusion_tpu_torch.ops.packed import packed_conv_plan
    from deepfusion_tpu_torch.types import dtype
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    M = importlib.import_module("deepfusion_tpu_torch.ops.mega")
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    rng = np.random.default_rng(9)
    fop, fb, macs = oncard.flagship_op(dev)
    fx = packed_input(rng, fop.sin, fb, dev)
    print_plan("packed_conv", "bench.py default", packed_conv_plan(fop, fb))
    encode_host_us(run, fx, fop.sin)
    bench_shape(run, "K5", "bench.py default 8x126x126x256 -> 3x3:256 -> "
                "1x1:256", lambda: PK.packed_conv_cuda(fop, [fx]), macs)
    del fop, fx
    int_mm_yardstick(run)
    dop, dmacs = oncard.flagship_dense(dev)
    c = dop.cfg
    dx = rand(rng, (c.bs, c.ih, c.iw, c.ic), dtype.u8, dev)
    print_plan("conv_fused", "bench.py --dense", conv_plan(dop, c.bs))
    bench_shape(run, "K1b", "bench.py --dense 8x126x126x256 -> 3x3:256 -> "
                "1x1:256", lambda: K.conv_cuda(dop, dx), dmacs)
    del dop, dx
    for name in ("block1", "block2"):
        c = getattr(net, name).cfg
        int_mm_yardstick(run, f"FusionNet {name}", c.bs * c.oh * c.ow,
                         ((c.kh * c.kw * c.ic, c.oc), (c.oc, c.oc1x1)))
    pop, pb, pmacs = oncard.flagship_pair(dev)
    px = packed_input(rng, pop.sin, pb, dev)
    print_plan("pair_conv", "bench.py --pair", pair_conv_plan(pop, pb))
    bench_shape(run, "K10", "bench.py --pair 8x126x126x256 -> (3x3:256 -> "
                "1x1:256) x2", lambda: M.pair_conv_cuda(pop, px), pmacs)
    del pop, px


def run_tree(tree):
    """Every entry, at the package first on sys.path (the tree's)."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.models import (FusionNet, FusionNetConfig,
                                             ResFusionNet, ResFusionNetConfig,
                                             VGGFusion, VGGFusionConfig)
    dev = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = Run()
    print(f"tree: {tree}, package {os.path.dirname(_build.__file__)}",
          flush=True)
    _build.kernels()
    us = host_us(_build.kernels, calls=10000, loops=1)
    run.out(f"host: _build.kernels() {us:.4f} us per call after the first "
            "(mean of 10000 calls)", **{"_build.kernels() host us": us})
    with torch.inference_mode():
        net = FusionNet(FusionNetConfig(), device=dev)
        fusionnet_times(run, net, dev)
        resfusion_times(run, ResFusionNet(ResFusionNetConfig(), device=dev),
                        dev)
        vggfusion_times(run, VGGFusion(VGGFusionConfig(), device=dev), dev)
        resnet50_stem_times(run, dev)
        depthwise_times(run, dev)
        bench_times(run, net, dev)
    # the heads: each launched once by the dense and once by the packed
    # forward
    models = {"Fd": "FusionNet dense", "Rd": "ResFusionNet dense",
              "Vd": "VGGFusion dense", "heads": "the three heads"}
    for g, (warm, cold, bound, n_l) in run.groups.items():
        run.out(f"timing: K1 sum over {models[g]} ({n_l} launches) "
                f"device_ms={warm:.4f} cold_device_ms={cold:.4f} bound_ms="
                f"{bound:.4f} cold_share={bound / cold:.4f}",
                **{f"K1 sum {models[g]}": warm,
                   f"K1 sum {models[g]} cold": cold})
    run.summary()
    return run.res


def main():
    trees = sys.argv[1:]
    if trees:
        oncard.run_trees("kernel_times", {t: t for t in trees})
        return
    if not torch.cuda.is_available():
        sys.exit("kernel_times: torch.cuda.is_available() is false; this "
                 "script needs an NVIDIA H100")
    sys.path.insert(0, oncard.ROOT)
    run_tree(oncard.ROOT)


if __name__ == "__main__":
    main()
