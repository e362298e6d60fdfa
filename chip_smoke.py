"""Drive the PyTorch port's main path once on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase-6b [nccl|gloo]    # phases 1, 2 and 6b

Phases, each printing its own lines:
  1. device: the card's name and power limit, compute capability 9.0;
  2. build: compile the CUDA kernels of deepfusion_tpu_torch/csrc; no
     function may issue mma.sync, and the SASS of every instance of the
     dense conv kernel (K1), its pool mode (K9) and the conv pair (K10)
     must issue wgmma on TMA-loaded tiles, and ptxas (-v) must not have
     serialized the wgmma of K5, K9 or K10 (its note C7520); the
     conversion instructions of two K1 instances and every K1 instance's
     registers and spills are printed; a
     _build.kernels() call after the first must return the same library
     in at most 5 host microseconds; the library must have registered
     every operator of torch.ops.deepfusion_torch that the wrappers call
     (csrc/*.cpp: one per launch entry point, a CUDA kernel and no CPU
     kernel for each op that takes a tensor) and export no C entry point
     (no dynamic symbol df_*); then the device rule:
     FusionNet(cfg) and conv() on a numpy input, given no device, must run
     on cuda:0 through the kernels;
  3. parity: each kernel against its plain PyTorch version on the card,
     bitwise, at every FusionNet, ResFusionNet, VGGFusion, ResNet-50 and
     GoogLeNet full-width layer shape (ResNet-50: every conv on full-range
     inputs and sum operands, its two pools, then one eager forward with
     each K1 and K3 launch held against its plain version; GoogLeNet, at
     batch 8 and again at the offline cell's 256: its 57 convs and head on
     full-range inputs, its three pool kinds, each module's concat, then
     one eager forward with each K1, K2 and K3 launch held against its
     plain version; MobileNetV2, at batch 8 and again at 256: its 36 dense
     convs on full-range inputs, s8 sources and s8 sums, its 17 depthwise
     layers (the depthwise kernel), its global average, then one eager
     forward with each K1, depthwise and K3 launch held against its plain
     version, and its logits against the benchmark's plain reference
     (portbench/reference/mobilenetv2.py)) and extra cases (every dtype, both round modes,
     saturation edges, the conv sum post-op with every operand dtype, the
     1-byte sum read as tiles at ResNet-50's fused shapes, the 1-byte
     final stage requantized in the integer domain (its fused blocks with
     u8 and s8 sums and its s8 projection at batch 256, x past +-2^21,
     sum_scale at the bound and past it, where the f32 path runs), every
     model op's conv_plan against the plans recorded before that read; for
     K1 also strides 2, 3 and above 8 with padding at both edges and odd
     output sizes, 1x1 GEMM tiles across images, ragged dst pitches, ic
     16, M below one tile, and the geometries of sp_conv's row slabs and
     tp_fused_conv's weight slices; for K2 also a 16-byte-misaligned view,
     non-contiguous inputs, 16 inputs, 17 and 40 inputs in every dtype in
     one launch each, 130 inputs in two, a pixel row wider than a block,
     and the reference's three s8 shape sets at batch 4 in every dtype
     (the wrapper's launch count held against the kernel launches that
     torch.profiler traces in the call), and the calls its op must refuse
     (CPU tensors, mixed devices, a dtype mismatch); for the fused
     conv+pool both pools, strides and sums; for the packed
     kernels also halo erosion, wide tap shifts, pad lanes, 1-3 inputs,
     the packed sum operand, the s2d stem, the fused 2x2 pool, the
     residual merge and pool (merge_pool: FusionNet's res, chunks of 64
     and 32 bytes, three inputs, two lane passes, tile edges, a deeper
     halo) and random bytes in the pad slots, and the input counts and
     lane widths the
     conv takes only joined (C13: five inputs, 8 + 24 lanes, six mixed
     widths, at 8x28x28 and at FusionNet's 8x56x56 and widths); the
     packed sum/pool (K6, K8) takes them as they are, in one launch with
     no other kernel in the call (five inputs, narrow ones, six mixed,
     8 + 120 lanes, lanes no multiple of 16 or of 4; 130 inputs in two
     launches); for the conv pair every fused combination
     with and without the pool, a channel change, round-down per-oc
     scales, deeper and shallower input halos, and bench.py's --pair
     shape); then, at the shapes tools/kernel_times.py times, FusionNet's
     res with merge_pool at batch 8 and 256 against its plain version, K9
     against K1 then K3's 2x2 max pool at its four layers, each VGGFusion
     pair against its packed conv a then conv b with pool2, and then K7,
     and bench.py's default, --dense and --pair shapes against their plain
     versions; then the kernel modes of the sharded path: K1b's and K5's raw
     1x1 accumulator, K5's output row ranges from input row slices, K10's
     widened intermediate bounds with row ranges (junk pads included); then
     every call of phase 6 and its single-device call once, each kernel
     launch inside them held against its plain version on the same inputs
     (the shapes, slices, ranges and bounds the wrappers give the kernels);
  4. slice: FusionNet(FusionNetConfig()), ResFusionNet(ResFusionNetConfig()),
     VGGFusion(VGGFusionConfig()), ResNet50(ResNet50Config()),
     GoogLeNet(GoogLeNetConfig()) and MobileNetV2(MobileNetV2Config()) on
     the card behind BatchServer each answer 20 requests through the dense
     forward, then 20 through the packed forward (ResNet-50, GoogLeNet and
     MobileNetV2 have none);
     VGGFusion's hybrid forward runs the golden batch; each
     answer must equal the model's plain dense forward on the CPU bitwise
     (and the JAX package's golden logits where stored), every kernel
     of each path must have been launched in that path's run, and each
     forward must launch what FORWARD_LAUNCHES says; then FusionNet,
     built on the CPU and batch-split by dp_shard over two slots that are
     both this card, answers 16 requests behind BatchServer at batch 16,
     checked the same way;
 4b. graphs: each model's jit() and jit_packed() (ResNet-50, GoogLeNet
     and MobileNetV2: jit() alone; one CUDA graph per input shape, models/graphed.py) at full width,
     batch 8: the first call captures; one replay must launch what
     FORWARD_LAUNCHES says, by the launch counters and by the kernels
     torch.profiler traces; a first result must survive a second call;
     batch 3 must capture a second graph; every answer, and 20 requests
     served behind BatchServer, bitwise equal to the CPU plain dense
     forward and the golden logits; last, the last model's graph must
     refuse a call once its model moved to the CPU, and once it moved back;
  5. (the kernels' times: tools/kernel_times.py; the forwards' and the
     served paths' times: the benchmark's cells, BENCHMARK.json);
  6. sharded: the parallel/ wrappers on meshes whose slots are all this
     card (tp_fused_conv and tp_packed_fused at tp 2 and 4, both wires;
     sp_conv at sp 2, 4 and dp 2 x sp 2; sp_packed on the packed conv at sp
     2 and 4; dp_shard of the four op families; sp_packed on VGGFusion's
     block 1 and 2 pairs with pool2; three_stage_plan at meshes (2, 2, 2)
     and (1, 1, 1)): the sharded calls alone between setting the launch
     counts to 0 and reading them, every kernel and mode of the path
     launched; then each result bitwise equal to the single-device call;
     then each wrapper's time against the single-device call (one card
     runs the shards in turn: the cost of sharding, not scaling); the
     launches must equal SHARDED_LAUNCHES;
 6b. across processes: two worker processes of this script (``--worker``)
     join one process group, over NCCL where there is a card per rank,
     else over gloo with both ranks on cuda:0 (the bytes then cross
     through host memory, and the times are not a multi-card run's); each
     rank first holds psum, psum_scatter, all_gather and ppermute of int32
     and uint8 parts on the card against one process's, then runs, on its
     block of each global input, dp_shard of FusionNet(FusionNetConfig())
     at global batch 16 (its own 8 images) and of VGGFusion's block-1
     ConvPoolOp, sp_conv, tp_fused_conv and tp_packed_fused (both wires)
     and sp_packed at bench.py's scaling layer, sp_packed of VGGFusion's
     block 1 and 2 pairs, and three_stage_plan at phase 6's widths on a
     (1, 2, 2) mesh of two slots per rank, between setting the launch
     counts to 0 and reading them (conv_fused, packed_conv, pair_conv and
     convpool must have launched on each rank); then each part bitwise
     equal to its block of the single-device call on the card, then each
     call's ms beside the single-device call's and the bytes its
     collectives moved between the ranks;
  7. object API: device_capabilities(), distributed.initialize() as a
     single-process no-op, then one chain of submits on cuda:0 from
     host-filled memory (concat -> fused conv -> max pool -> eltwise sum)
     with DEEPFUSION_PROFILE=1: every result a CUDA tensor, every kernel
     of the chain launched, a profile line per submit, the result bitwise
     the functional ops' on the CPU; then each submit's host time against
     its functional call's, in turns.

Phases 6, 6b and 7 also print a few times (``timing:`` and ``api: host``
lines): a sharded call's and a process group's cost against the single-device
call, an object-API submit's against its functional call, which nothing
else measures.

Any failure raises and exits non-zero; nothing is caught. The line before
the last is the per-kernel JSON summary (each kernel's name, route, source
and launches), the last line the device JSON.
"""
import contextlib
import importlib
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
from oncard import (CONCAT_SETS, C13_CONVS, c13_sum_pool_cases,  # noqa: E402
                    card, cuda_ms, flagship_dense, flagship_op,
                    flagship_pair, packed_conv_op, packed_input, rand)

GOLDEN = {m: os.path.join(ROOT, "tests", "data", f"{f}_full_logits.npz")
          for m, f in (("FusionNet", "fusionnet"),
                       ("ResFusionNet", "resfusion"),
                       ("VGGFusion", "vggfusion"))}
# each counted kernel's source
KERNEL_INFO = {
    "conv_fused": "deepfusion_tpu_torch/csrc/conv.cu",
    "concat_relu": "deepfusion_tpu_torch/csrc/concat.cu",
    "pool": "deepfusion_tpu_torch/csrc/pool.cu",
    "sum_relu": "deepfusion_tpu_torch/csrc/sum_relu.cu",
    "packed_conv": "deepfusion_tpu_torch/csrc/packed_conv.cu",
    "packed_sum_pool": "deepfusion_tpu_torch/csrc/packed_sum_pool.cu",
    "convpool": "deepfusion_tpu_torch/csrc/conv.cu",
    "pair_conv": "deepfusion_tpu_torch/csrc/pair_conv.cu",
    "unfold_cols": "deepfusion_tpu_torch/csrc/unfold.cu",
    "depthwise": "deepfusion_tpu_torch/csrc/depthwise.cu",
}
# the kernels each served path launches (the packed heads are dense convs)
PATH_KERNELS = {
    ("FusionNet", "dense"): ("conv_fused", "concat_relu", "pool", "sum_relu"),
    ("FusionNet", "packed"): ("packed_conv", "conv_fused"),
    ("ResFusionNet", "dense"): ("conv_fused", "convpool", "pool"),
    ("ResFusionNet", "packed"): ("packed_conv", "packed_sum_pool",
                                 "conv_fused"),
    ("VGGFusion", "dense"): ("conv_fused", "convpool", "pool"),
    ("VGGFusion", "packed"): ("pair_conv", "conv_fused"),
    ("VGGFusion", "hybrid"): ("pair_conv", "conv_fused", "convpool", "pool"),
    ("ResNet50", "dense"): ("conv_fused", "pool", "unfold_cols"),
    ("GoogLeNet", "dense"): ("conv_fused", "concat_relu", "pool",
                             "unfold_cols"),
    ("MobileNetV2", "dense"): ("conv_fused", "depthwise", "pool",
                               "unfold_cols"),
}
# launches of one forward of each served model path, and of phase 6's
# sharded calls: what the kernels' launch paths have made since they
# settled; a change to a model's launches must change these deliberately
FORWARD_LAUNCHES = {
    "FusionNet dense": {"conv_fused": 6, "concat_relu": 1, "pool": 2,
                        "sum_relu": 1},
    "FusionNet packed": {"conv_fused": 1, "packed_conv": 5},
    "ResFusionNet dense": {"conv_fused": 4, "pool": 1, "convpool": 1},
    "ResFusionNet packed": {"conv_fused": 1, "packed_conv": 4,
                            "packed_sum_pool": 1},
    "VGGFusion dense": {"conv_fused": 4, "pool": 1, "convpool": 3},
    "VGGFusion packed": {"conv_fused": 1, "pair_conv": 3},
    # the stem, 16 reduces, 4 projections, 16 fused blocks and the head;
    # the max pool and the global average; the stem's input unfolded
    "ResNet50 dense": {"conv_fused": 38, "pool": 2, "unfold_cols": 1},
    # the stem, conv2's 1x1 and 3x3, six convs in each of the nine modules
    # and the head; the nine modules' concats; four 3x3/s2 max pools, nine
    # branch pools and the global average; the stem's input unfolded
    "GoogLeNet dense": {"conv_fused": 58, "concat_relu": 9, "pool": 14,
                        "unfold_cols": 1},
    # the stem, 16 expands, 17 projections, the last 1x1 and the head; the
    # 17 depthwise layers; the global average; the stem's input unfolded
    "MobileNetV2 dense": {"conv_fused": 36, "depthwise": 17, "pool": 1,
                          "unfold_cols": 1},
    # two shards of one forward each per served batch
    "FusionNet dense dp=2 split": {"conv_fused": 12, "concat_relu": 2,
                                   "pool": 4, "sum_relu": 2},
}
SHARDED_LAUNCHES = {"conv_fused": 58, "packed_conv": 32, "convpool": 2,
                    "pair_conv": 38}
# K1 launches a forward in a counted mode, per served path (every path not
# named none), and what the mode does
FORWARD_MODES = {
    # ops/conv.py: tiled_sum; ResNet-50's 16 fused blocks, ResFusionNet's
    # block1
    "conv_fused.sum_tile": ({"ResNet50 dense": 16, "ResFusionNet dense": 1},
                            "read the sum operand as tiles"),
    # ops/conv.py: unfold_cols; ResNet-50's, GoogLeNet's and MobileNetV2's
    # stem
    "conv_fused.unfold": ({"ResNet50 dense": 1, "GoogLeNet dense": 1,
                           "MobileNetV2 dense": 1},
                          "ran over unfolded column taps"),
    # ops/conv.py: int_requant; ResNet-50's 16 fused blocks (a 1-byte sum)
    # and 4 projections (s8), ResFusionNet's block1, MobileNetV2's 17
    # projections (s8, 10 with an s8 sum)
    "conv_fused.int_requant": ({"ResNet50 dense": 20,
                                "ResFusionNet dense": 1,
                                "MobileNetV2 dense": 17},
                               "requantized in the integer domain"),
    # ops/conv.py: conv_cuda (an s8 src); MobileNetV2's 16 expands and its
    # last 1x1
    "conv_fused.s8_src": ({"MobileNetV2 dense": 17}, "read an s8 source"),
}
# conv_plan of every dense conv op of the four models at batch 8 and 256
# ("<model> <module> <batch>"), as the launcher planned them before the
# sum operand was read as tiles: a plan may add keys, never change these
CONV_PLANS = os.path.join(ROOT, "tests", "data", "conv_plans.json")
# the kernel modes of the sharded path (packed_conv.merge_pool is
# FusionNet's packed forward's, never a shard's)
SHARDED_MODES = ("conv_fused.acc1", "packed_conv.acc1", "packed_conv.rows",
                 "pair_conv.rows", "pair_conv.bounds")
# three_stage_plan in phase 6: bench.py's scaling-plan widths (64
# channels, bench.py:673-678) at hw 128, batch 8 per dp shard
PLAN = dict(mb=16, hw=128, c=64)


# a profile keeps only the device work whose timestamps fall inside its
# window, and work that starts or ends right at an edge can fall outside it
# (a lone kernel went untraced three profiles running, PERF.md §7): a
# profiled call starts and ends this long inside the window
TRACE_EDGE_S = 0.01


def kernel_counts(fn):
    """(fn()'s result, {device kernel name: launches} that torch.profiler
    traced in that call)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_EDGE_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_EDGE_S)
    return out, {e.key: e.count for e in prof.key_averages()
                 if e.self_device_time_total > 0}


def counted_and_traced(fn, counter, match):
    """(fn()'s result, the launches of `counter` that the package counted in
    the call, {device kernel name: launches} that torch.profiler traced in
    it). A profile may drop a kernel's record (PERF.md §7), never add one:
    up to TRACE_TRIES calls, each under its own profile, until one traces
    as many launches of kernels whose name holds `match` as it counted."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.utils.logger import check
    for tries in range(1, TRACE_TRIES + 1):
        before = _build.launch_counts()[counter]
        out, ran = kernel_counts(fn)
        launches = _build.launch_counts()[counter] - before
        traced = sum(v for k, v in ran.items() if match in k)
        check(traced <= launches, f"{counter}: a call traced {traced} "
              f"launches of {match}, more than the {launches} it counted")
        if traced == launches:
            break
        print(f"parity: {counter}: profile {tries} traced {traced} of the "
              f"{launches} launches counted", flush=True)
    return out, launches, ran


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
        self.cases[kernel] += 1
        if torch.equal(got, want):
            return
        g, w = got.cpu().numpy(), want.cpu().numpy()
        err = float(np.max(np.abs(g.astype(np.float64) - w.astype(np.float64)),
                           initial=0.0))
        self.err[kernel] = max(self.err[kernel], err)
        if not np.array_equal(g, w, equal_nan=True):
            bad = np.argwhere(g != w)[:5]
            raise AssertionError(
                f"{kernel} {what}: not bitwise equal to the plain version; "
                f"max_abs_err {err}, first mismatches at {bad.tolist()}")


@contextlib.contextmanager
def held_against_plain(par: Parity, label: str):
    """Inside the block, every launch of K1, K2, K3, K5, K9, K10 and the
    depthwise kernel through its op (the ops look their launchers up at
    each call) is followed by
    the plain version on the same inputs and arguments, and the two must
    be bitwise equal: the kernels are held at the very shapes, slices, row
    ranges and bounds the code under test gives them."""
    launchers = [("conv_fused", "conv", "conv_cuda", "conv_plain"),
                 ("concat_relu", "concat", "concat_cuda", "concat_plain"),
                 ("pool", "pool", "pool_cuda", "pool_plain"),
                 ("convpool", "convpool", "convpool_cuda", "convpool_plain"),
                 ("packed_conv", "packed", "packed_conv_cuda",
                  "packed_conv_plain"),
                 ("pair_conv", "mega", "pair_conv_cuda", "pair_conv_plain"),
                 ("depthwise", "depthwise", "depthwise_cuda",
                  "depthwise_plain")]
    saved = []
    for kernel, mod, cuda, plain in launchers:
        m = importlib.import_module(f"deepfusion_tpu_torch.ops.{mod}")
        real, ref = getattr(m, cuda), getattr(m, plain)

        def tap(*a, kernel=kernel, real=real, ref=ref, **kw):
            got = real(*a, **kw)
            args = " ".join(f"{k}={v}" for k, v in kw.items()
                            if v is not None and v is not False and v != 0)
            par.check(kernel, f"{label}: {type(a[0]).__name__} "
                              f"{tuple(got.shape)} {args}",
                      got, ref(*a, **kw))
            return got
        saved.append((m, cuda, real))
        setattr(m, cuda, tap)
    try:
        yield
    finally:
        for m, cuda, real in saved:
            setattr(m, cuda, real)


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


def phase_build(name_power):
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.utils.logger import check
    # ptxas -v: the build also writes ptxas's report (serialized_check)
    os.environ["DEEPFUSION_DUMP_CODE"] = "1"
    t0 = time.perf_counter()
    lib = _build.kernels()
    print(f"build: {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sass_check(_build.library_path())
    serialized_check(_build.library_path().with_suffix(".ptxas.txt"))
    # every launch asks for the library: after the first call that must
    # cost next to nothing (no hashing, no opening)
    calls = 10000
    t0 = time.perf_counter()
    for _ in range(calls):
        check(_build.kernels() is lib, "kernels() opened the library again")
    us = (time.perf_counter() - t0) / calls * 1e6
    print(f"host: _build.kernels() {us:.4f} us per call after the first "
          f"(mean of {calls} calls) card=\"{name_power}\"", flush=True)
    check(us <= 5.0, f"_build.kernels() takes {us:.2f} us per call")
    ops_check(_build.library_path())


# every op of torch.ops.deepfusion_torch that the wrappers call
OPS = ("concat_relu", "pool", "sum_relu", "conv_fused", "convpool",
       "conv_weight_maps", "conv_plan", "packed_conv", "packed_weight_maps",
       "packed_plan", "packed_sum_pool", "pair_conv", "pair_plan",
       "empty_launches", "unfold_cols", "depthwise")


def ops_check(lib):
    """The library's registered operators: each op the wrappers call
    resolves, one that takes a tensor has a CUDA kernel and no CPU one (a
    CPU tensor raises in the dispatcher), a plan (ints alone) one kernel for
    every backend; and the library exports no C entry point (the ctypes
    binding's df_* functions are gone)."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.utils.logger import check
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    for name in OPS:
        schema = _build.op(name)._schema
        qual = f"deepfusion_torch::{name}"
        if any("Tensor" in str(a.type) for a in schema.arguments):
            check(has(qual, "CUDA") and not has(qual, "CPU"),
                  f"{qual}: needs a CUDA kernel and no CPU kernel")
        else:
            check(has(qual, "CompositeExplicitAutograd"),
                  f"{qual}: needs a kernel for every backend")
        print(f"build: registered {schema}", flush=True)
    syms = subprocess.run(["nm", "-D", "--defined-only", str(lib)],
                          capture_output=True, text=True,
                          check=True).stdout.split()
    check(len(syms) > 100, f"nm -D listed {len(syms)} words")
    exported = sorted(w for w in syms if w.startswith("df_"))
    check(not exported, f"the library exports C entry points {exported}")
    print(f"build: {len(OPS)} ops resolve; no df_* symbol among the "
          f"library's {len(syms) // 3} dynamic symbols", flush=True)


# The K1 instances that ptxas is known to serialize (C7520): the 1-byte
# dsts, s8 (dtype code 3) and u8 (4), fused and not, and the s8-source
# instance (into u8); the cause is open.
K1_SERIALIZED = {f"conv_fused_kernelILb{f}ELi{d}E" for f in (0, 1)
                 for d in (3, 4)} | {"conv_fused_s8src_kernelILi4E"}
# the names of K1's instances: u8 sources, and the s8 source
K1_NAMES = ("conv_fused_kernel", "conv_fused_s8src_kernel")


def serialized_check(report):
    """ptxas's note C7520 ("wgmma.mma_async instructions are serialized"):
    the function then waits out each wgmma before issuing the next. A lane
    shuffle, or a __syncwarp in a loop whose exit depends on the
    warpgroup, in K9's and K10's pool epilogues caused it. K5, K9 and K10
    must carry no such note, and the K1 instances that carry it must be
    exactly K1_SERIALIZED: a new one fails, and so does one that no longer
    carries it (then the set is out of date)."""
    from deepfusion_tpu_torch.utils.logger import check
    text = open(report).read()
    fns = set(re.findall(r"\(C7520\).*function '([^']+)'", text))
    for kernel, name in (("K1", "conv_fused_kernel"),
                         ("K1 s8 source", "conv_fused_s8src_kernel"),
                         ("K5", "packed_conv_kernel"),
                         ("K9", "convpool_kernel"),
                         ("K10", "pair_conv_kernel")):
        print(f"ptxas: {kernel} {name} instances with serialized wgmma "
              f"(C7520): {sum(name in f for f in fns)}", flush=True)
    k1 = {f for f in fns if any(n in f for n in K1_NAMES)}
    known = {k for k in K1_SERIALIZED if any(k in f for f in k1)}
    unknown = sorted(f for f in k1 if not any(k in f for k in K1_SERIALIZED))
    check(known == K1_SERIALIZED and not unknown,
          f"K1 instances with C7520: {sorted(k1)}; expected exactly "
          f"{sorted(K1_SERIALIZED)}")
    bad = sorted(f for f in fns if f not in k1)
    check(not bad, f"ptxas serialized the wgmma of {bad}")
    for fn, (regs, st, ld) in sorted(ptxas_usage(report).items()):
        if any(n in fn for n in K1_NAMES):
            print(f"ptxas: K1 {fn[:72]} registers {regs}, spill stores {st} "
                  f"B, spill loads {ld} B", flush=True)


# an instruction of the SASS's conversion unit (16 results a clock an SM
# on sm_90): int -> f32, f32 -> int, f32 round to integral, int -> int,
# f32 -> f32 of another width
SASS_CONVERSION = re.compile(
    r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]\s+)?((?:I2F|F2I|FRND|I2I|F2F)"
    r"[A-Z0-9_.]*)")
# the K1 instances whose conversions sass_check prints: the fused kernel
# into u8 (ResNet-50's 16 blocks) and the unfused into s8 (its projections)
K1_CONVERSIONS = ("conv_fused_kernelILb1ELi4E", "conv_fused_kernelILb0ELi3E")


def ptxas_usage(report):
    """{function: (registers, spill store bytes, spill load bytes)} from
    ptxas's -v report."""
    out, cur, spill = {}, None, (0, 0)
    for line in open(report):
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m[1]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m[1]), int(m[2]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur] = (int(m[1]), *spill)
            cur, spill = None, (0, 0)
    return out


def sass_check(lib):
    """cuobjdump -sass of the built library: no function issues mma.sync
    (IMMA.16832); every instance of the dense conv kernel (K1,
    conv_fused_kernel, nine) and of its pool mode (K9, convpool_kernel,
    four) issues wgmma u8 x s8 (IGMMA.64xNx32.U8.S8) only, its s8-source
    instance (conv_fused_s8src_kernel, one) s8 x s8 only, and every
    instance of the conv pair (K10, pair_conv_kernel, four) wgmma s8 x s8
    (layer a's packed read) and u8 x s8 (layer b and the 1x1s), each on
    tiles that TMA loads (UTMALDG). Prints the conversion instructions
    (SASS_CONVERSION) of the K1 instances K1_CONVERSIONS."""
    from deepfusion_tpu_torch._build import _nvcc
    from deepfusion_tpu_torch.utils.logger import check
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = {"igmma": set(), "utmaldg": 0, "imma": 0,
                          "conv": {}}
        elif cur is not None:
            f = funcs[cur]
            if "IGMMA." in line:
                f["igmma"].add(line.split("IGMMA.")[1].split()[0])
            f["utmaldg"] += "UTMALDG" in line
            f["imma"] += "IMMA.16832" in line
            m = SASS_CONVERSION.search(line)
            if m:
                f["conv"][m[1]] = f["conv"].get(m[1], 0) + 1
    imma = sorted(k for k, f in funcs.items() if f["imma"])
    check(not imma, f"functions issuing mma.sync (IMMA.16832): {imma}")
    for kernel, name, count, types in (
            ("K1", "conv_fused_kernel", 9, {"U8.S8"}),
            ("K1 s8 source", "conv_fused_s8src_kernel", 1, {"S8.S8"}),
            ("K9", "convpool_kernel", 4, {"U8.S8"}),
            ("K10", "pair_conv_kernel", 4, {"S8.S8", "U8.S8"})):
        inst = {k: v for k, v in funcs.items() if name in k}
        check(len(inst) == count, f"expected {count} {name} instances in the "
                                  f"SASS, found {len(inst)}")
        for fn, f in inst.items():
            got = {g.split(".", 1)[1] for g in f["igmma"]}
            print(f"sass: {kernel} {fn[:72]} IGMMA {sorted(f['igmma'])} "
                  f"UTMALDG {f['utmaldg']} IMMA.16832 {f['imma']}",
                  flush=True)
            check(got == types and f["utmaldg"] > 0,
                  f"{fn}: {kernel} must issue IGMMA {sorted(types)} on "
                  "UTMALDG tiles")
    for inst in K1_CONVERSIONS:
        (fn,) = [k for k in funcs if inst in k]
        print(f"sass: K1 {inst} conversions {funcs[fn]['conv']}",
              flush=True)


def phase_default_device(cfg):
    """The device rule: a model and a functional call given no device run
    on the current CUDA device (cuda:0 here), through the kernels; the
    functional call equals the same call on the CPU (device="cpu")
    bitwise. Returns the model."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.models import FusionNet
    from deepfusion_tpu_torch.ops.conv import conv
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    cuda0 = torch.device("cuda", 0)
    net = FusionNet(cfg)
    check(all(b.device == cuda0 for b in net.buffers()),
          "FusionNet(cfg) with no device must be built on cuda:0")
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (2, 9, 9, 32), dtype=np.uint8)
    w = rng.integers(-128, 128, (48, 32, 3, 3)).astype(np.int8)
    kw = dict(dst_dtype="u8", conv0_relu=True, conv0_scales=(1 / 5000,))
    _build.reset_launch_counts()
    with torch.inference_mode():
        y = conv(x, w, None, (1, 1), (1, 1), **kw)
        logits = net(net.example_input())
        torch.cuda.synchronize()
    counts = _build.launch_counts()
    check(y.device == cuda0 and logits.device == cuda0,
          "conv() and the model's forward on numpy inputs given no device "
          "must run on cuda:0")
    check_eq(counts["conv_fused"], 1 + 6, "K1 launches of conv() and one "
                                          "FusionNet forward")
    for k in PATH_KERNELS[("FusionNet", "dense")]:
        check(counts[k] > 0, f"kernel {k} was not launched by FusionNet(cfg)")
    want = conv(x, w, None, (1, 1), (1, 1), **kw, device="cpu")
    check(torch.equal(y.cpu(), want), "conv() on cuda:0 differs from the "
                                      "same call with device=\"cpu\"")
    print(f"default device: FusionNet(cfg) and conv(numpy) given no device "
          f"ran on {cuda0} through the kernels (launches {counts}); conv() "
          "bitwise equal to device=\"cpu\"", flush=True)
    return net


def conv_cases(dev):
    """(label, ConvOp, input, sum operand or None) for the extra K1 cases."""
    from deepfusion_tpu_torch.config import ConvConfig
    from deepfusion_tpu_torch.ops.conv import ConvOp
    from deepfusion_tpu_torch.types import dtype
    from deepfusion_tpu_torch.utils.mathutil import conv_output_size
    rng = np.random.default_rng(11)
    out = []

    def add(label, n, hw, ic, oc, k, s, p, dst, *, oc1=None, bias=True,
            per_oc=True, rnd="nearest", relu=True, scale=None, sum_dt=None,
            sum_scale=1.0):
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
                              conv0_round=rnd, sum_dt=sum_dt,
                              sum_scale=sum_scale, **kw)
        wei1 = bia1 = None
        if oc1 is not None:
            wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
            bia1 = rng.integers(-5000, 5000, (oc1,)).astype(np.int32)
        x = torch.from_numpy(rng.integers(0, 256, (n, hw, hw, ic),
                                          dtype=np.uint8)).to(dev)
        sm = None if sum_dt is None else rand(
            rng, (n, o, o, oc1 or oc), dtype.from_any(sum_dt), dev)
        out.append((label, ConvOp(cfg, wei, bia, wei1, bia1, device=dev), x,
                    sm))

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
    # the sum post-op: every operand dtype into every dst, fused or not,
    # both round modes, sum_scale != 1, then saturation at both ends
    for i, sdt in enumerate(("u8", "s8", "s32", "f32")):
        for j, dst in enumerate(("u8", "s8", "s32", "f32")):
            for oc1 in (None, 32):
                rnd = ("nearest", "down")[(i + j) % 2]
                add(f"sum {sdt} -> {dst} fused={oc1 is not None} {rnd}", 2,
                    10, 32, 48, 3, 1, 1, dst, oc1=oc1, rnd=rnd,
                    relu=dst != "s8", sum_dt=sdt, sum_scale=0.75)
    add("sum s8 stride2 odd ic", 2, 13, 3, 40, 3, 2, 1, "s8", relu=False,
        sum_dt="s8", sum_scale=1.5)
    # what the TMA addressing and the tiling can get wrong: stride 2 with
    # padding at both edges and odd output sizes; 1x1 GEMM tiles across
    # image and batch boundaries; oc 8 and oc no multiple of 16 (a ragged
    # dst pitch, byte stores), ic 16, M below one tile (the head), strides
    # above TMA's 8 (gathered by the wrapper), oc0p 136 (a pass wider than
    # the weights), both pass splits
    for hw, o in ((17, "odd 9"), (15, "even 8"), (31, "odd 16")):
        add(f"3x3 stride2 pad1 {hw} -> {o}", 2, hw, 32, 64, 3, 2, 1, "u8")
    add("3x3 stride2 pad1 fused sum", 3, 21, 16, 40, 3, 2, 1, "u8", oc1=24,
        sum_dt="u8")
    add("5x5 stride3 pad2 odd", 1, 20, 16, 24, 5, 3, 2, "s8", relu=False)
    add("1x1 GEMM 3x7x7 (tiles cross images)", 3, 7, 64, 64, 1, 1, 0, "u8")
    add("1x1 GEMM 5x13x13 s32", 5, 13, 32, 48, 1, 1, 0, "s32", relu=False)
    add("fused 1x1 GEMM 3x9x9", 3, 9, 32, 64, 1, 1, 0, "u8", oc1=32)
    add("oc 8 u8", 2, 9, 32, 8, 3, 1, 1, "u8")
    add("oc 24 s8", 2, 9, 32, 24, 3, 1, 1, "s8", relu=False)
    add("oc 40 u8 fused oc1 20", 2, 9, 32, 40, 3, 1, 1, "u8", oc1=20)
    add("oc 130 (oc0p 136) u8", 1, 10, 32, 130, 3, 1, 1, "u8")
    add("fused oc0 136 oc1 264 u8", 1, 10, 32, 136, 3, 1, 1, "u8", oc1=264)
    add("ic 16 3x3", 2, 12, 16, 64, 3, 1, 1, "u8")
    add("ic 16 fused", 2, 12, 16, 32, 3, 1, 1, "u8", oc1=64)
    add("head-like M=8 f32", 8, 1, 128, 128, 1, 1, 0, "f32", relu=False)
    add("head-like M=3 f32 odd oc", 3, 1, 64, 37, 1, 1, 0, "f32",
        relu=False)
    add("M=1 3x3 u8", 1, 1, 32, 64, 3, 1, 1, "u8")
    add("1x1 stride 9 (gathered)", 2, 20, 32, 32, 1, 9, 0, "s32",
        relu=False)
    add("3x3 stride 10 pad 1 (gathered)", 2, 23, 32, 32, 3, 10, 1, "u8")
    for dst, sdt in (("u8", "s32"), ("s8", "s32"), ("s32", "s32"),
                     ("s8", "f32")):
        add(f"sum saturate {sdt} -> {dst}", 1, 8, 64, 32, 3, 1, 1, dst,
            relu=False, scale=1e6 if dst == "s32" else 0.05, sum_dt=sdt,
            sum_scale=3.0)
    # the sum operand read as tiles (ops/conv.py: tiled_sum): ResNet-50's
    # fused blocks at each stage's widths, batch 2 (split plans), with the
    # u8 (identity) and the s8 (projection, stride 2 from stage 2) shortcut,
    # 1-8 passes of 256 lanes; stage 1 at batch 4 (128-pixel tiles); stages
    # 2-4 at the offline cell's batch 256, whose plans take whole tiles
    # over 2, 4 and 8 passes (each next pass's copy after the previous
    # pass's store, stage 4's first before a 2-stage ring's 3x3); odd
    # output sizes at stride 2 (tiles across the image's edge); sum_scale
    # != 1 in both round modes; an s8 dst; the staging rows in the
    # intermediate's (one pass of 32 lanes); and a pitch oc1 no multiple of
    # 16, which keeps the per-value read
    for st, (hw, w) in enumerate(((56, 64), (28, 128), (14, 256), (7, 512)),
                                 1):
        for sdt, s in (("u8", 1), ("s8", 2 if st > 1 else 1)):
            add(f"tiled sum {sdt} ResNet-50 stage {st} stride {s}", 2,
                hw * s, w, w, 3, s, 1, "u8", oc1=4 * w, sum_dt=sdt)
    add("tiled sum u8 ResNet-50 stage 1 batch 4", 4, 56, 64, 64, 3, 1, 1,
        "u8", oc1=256, sum_dt="u8")
    for st, hw, w, sdt, s in ((2, 56, 128, "s8", 2), (3, 14, 256, "u8", 1),
                              (4, 14, 512, "s8", 2)):
        add(f"tiled sum {sdt} ResNet-50 stage {st} stride {s} batch 256",
            256, hw, w, w, 3, s, 1, "u8", oc1=4 * w, sum_dt=sdt)
    add("tiled sum s8 stride 2 13 -> 7 sum_scale 0.75", 2, 13, 64, 64, 3,
        2, 1, "u8", oc1=256, sum_dt="s8", sum_scale=0.75)
    add("tiled sum u8 stride 2 27 -> 14 down sum_scale 1.5", 3, 27, 32, 48,
        3, 2, 1, "u8", oc1=528, rnd="down", sum_dt="u8", sum_scale=1.5)
    add("tiled sum s8 -> s8 dst", 2, 10, 32, 64, 3, 1, 1, "s8", oc1=96,
        relu=False, sum_dt="s8", sum_scale=0.5)
    add("tiled sum u8 in the intermediate's rows", 2, 9, 32, 64, 3, 1, 1,
        "u8", oc1=32, sum_dt="u8")
    add("per-value sum u8 oc1 264 (pitch no multiple of 16)", 2, 12, 32, 64,
        3, 1, 1, "u8", oc1=264, sum_dt="u8")
    # the final stage in the integer domain (requant.cuh: requant_int) at
    # the offline cell's batch 256: ResNet-50's fused blocks with a u8 and
    # an s8 sum, its stage-2 projection into s8; scales 4 and 16 put x
    # around and past +-2^21 and 2^22 (saturation through the clamp), ReLU
    # off lets both ends show; a per-value (ragged pitch) and an unfused
    # sum; sum_scale at the bound (integer path, the sum read as tiles)
    # and past it (the f32 path, requant_sum, the sum read a value at a
    # time, in the same kernel)
    for sc in (4.0, 16.0):
        add(f"int requant u8 sum ResNet-50 stage 3 batch 256 scale {sc}",
            256, 14, 256, 256, 3, 1, 1, "u8", oc1=1024, sum_dt="u8",
            scale=sc)
        add(f"int requant s8 sum ResNet-50 stage 2 stride 2 batch 256 scale "
            f"{sc} no ReLU -> s8", 256, 56, 128, 128, 3, 2, 1, "s8", oc1=512,
            sum_dt="s8", scale=sc, relu=False, rnd="down")
        add(f"int requant s8 projection ResNet-50 stage 2 batch 256 scale "
            f"{sc}", 256, 56, 256, 512, 1, 2, 0, "s8", relu=False, scale=sc)
    add("int requant s8 projection ResNet-50 stage 2 batch 256", 256, 56,
        256, 512, 1, 2, 0, "s8", relu=False, scale=1.0 / (256 * 40))
    add("int requant per-value s8 sum oc1 264 scale 16", 2, 12, 32, 64, 3, 1,
        1, "s8", oc1=264, sum_dt="s8", scale=16.0, relu=False,
        sum_scale=-3.0)
    add("int requant unfused u8 sum scale 16", 2, 12, 64, 96, 3, 1, 1, "u8",
        sum_dt="u8", scale=16.0, sum_scale=2.5)
    for sdt, ss in (("u8", 8192.0), ("s8", -8192.0), ("u8", 8192.5),
                    ("s8", -9000.0), ("u8", 1e30)):
        path = "integer" if abs(ss) <= 8192.0 else "f32 fallback"
        add(f"{path} sum_scale {ss} fused {sdt} sum batch 256", 256, 14,
            256, 256, 3, 1, 1, "u8", oc1=1024, sum_dt=sdt, scale=4.0,
            sum_scale=ss, relu=False)
        add(f"{path} sum_scale {ss} per-value {sdt} sum -> s8", 2, 12, 32,
            64, 3, 1, 1, "s8", oc1=264, sum_dt=sdt, scale=4.0, sum_scale=ss,
            relu=False)
    return out


def k1_geometry_cases(net, dev):
    """(label, ConvOp) for K1 at the geometries the sharded wrappers give
    it: sp_conv's row slabs of FusionNet's block1 and block2
    (``ConvOp.with_geometry``: the interior of 2 and 4 shards, the top and
    bottom slabs) and tp_fused_conv's weight slices (oc 64 and 32 of
    block1's 128, as its tp = 2 and 4 shards; fused, for the raw 1x1
    accumulator)."""
    from deepfusion_tpu_torch.config import ConvConfig
    from deepfusion_tpu_torch.ops.conv import ConvOp
    out = []
    for name in ("block1", "block2"):
        op = getattr(net, name)
        c = op.cfg
        for sp in (2, 4):
            ih = c.ih // sp
            out.append((f"{name} sp={sp} interior slab",
                        op.with_geometry(ph=0, ih=ih, oh=ih - c.kh + 1)))
        out.append((f"{name} top slab", op.with_geometry(
            ph=0, ih=c.ph + c.kh - 1, oh=c.ph)))
        kb = c.kh - 1 - c.ph
        out.append((f"{name} bottom slab", op.with_geometry(
            ph=0, ih=kb + c.kh - 1, oh=kb)))
    p = net.params["block1"]
    c = net.block1.cfg
    for tp in (2, 4):
        k = c.oc // tp
        sc = np.asarray(p["conv0_scales"])
        cfg = ConvConfig.make(
            (c.bs, c.ih, c.iw, c.ic), (k, c.ic, c.kh, c.kw), np.int32,
            (c.sh, c.sw), (c.ph, c.pw), (c.bs, c.oh, c.ow, c.oc1x1), "u8",
            conv0_relu=True, conv0_scales=sc[:k],
            wei1x1_shape=(c.oc1x1, k, 1, 1), bia1x1_dt=np.int32,
            conv1_relu=True, conv1_scales=p["conv1_scales"])
        out.append((f"block1 tp={tp} slice oc {k}", ConvOp(
            cfg, p["wei"][:k], p["bia"][:k], p["wei1"][:, :k], p["bia1"],
            device=dev)))
    return out


def convpool_cases(dev):
    """(label, ConvPoolOp, input, sum operand or None) for the K9 cases:
    max/avg x dst x both conv and pool round modes x no/u8/s32 sum x
    (stride 1, stride 2, odd ic), then saturating conv values."""
    from deepfusion_tpu_torch.config import ConvConfig, PoolConfig
    from deepfusion_tpu_torch.ops.convpool import ConvPoolOp
    from deepfusion_tpu_torch.types import dtype
    from deepfusion_tpu_torch.utils.mathutil import conv_output_size
    rng = np.random.default_rng(13)
    out = []

    def add(label, n, hw, ic, oc, s, dst, kind, r0, rp, sum_dt, scale=None):
        o = conv_output_size(hw, 3, s, 1)
        wei = rng.integers(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
        bia = rng.integers(-5000, 5000, (oc,)).astype(np.int32)
        sc = scale if scale is not None else 1.0 / (9 * ic * 60)
        cfg = ConvConfig.make(
            (n, hw, hw, ic), (oc, ic, 3, 3), bia.dtype, (s, s), (1, 1),
            (n, o, o, oc), dst, conv0_relu=dst != "s8",
            conv0_scales=(rng.uniform(0.5, 1.5, oc) * sc).astype(np.float32),
            conv0_round=r0, sum_dt=sum_dt, sum_scale=0.5)
        pc = PoolConfig.make(kind, (o, o), (2, 2), (2, 2), (0, 0), rp)
        x = torch.from_numpy(rng.integers(0, 256, (n, hw, hw, ic),
                                          dtype=np.uint8)).to(dev)
        sm = None if sum_dt is None else rand(
            rng, (n, o, o, oc), dtype.from_any(sum_dt), dev)
        out.append((label, ConvPoolOp(cfg, pc, wei, bia, device=dev), x, sm))

    geos = (("stride 1", 8, 32, 40, 1), ("stride 2", 16, 32, 24, 2),
            ("odd ic", 8, 3, 16, 1))
    for kind in ("max", "avg_exc"):
        for dst in ("u8", "s8", "s32", "f32"):
            if kind != "max" and dst == "s32":
                continue
            for r0 in ("nearest", "down"):
                for rp in ("nearest", "down"):
                    for sdt in (None, "u8", "s32"):
                        for g, hw, ic, oc, s in geos:
                            add(f"{kind} {dst} conv={r0} pool={rp} "
                                f"sum={sdt} {g}", 2, hw, ic, oc, s, dst,
                                kind, r0, rp, sdt)
    for dst, kind in (("u8", "max"), ("s8", "avg_exc"), ("s32", "max")):
        add(f"saturate {kind} {dst}", 1, 8, 64, 32, 1, dst, kind, "nearest",
            "nearest", None, scale=1e6 if dst == "s32" else 0.05)
    # the tile edges of the wgmma kernel's pool mode (convpool_plan): lanes
    # split over the grid at a block 3-sized layer, an odd tile count with
    # a partial last tile, two passes of 256 lanes, strides above TMA's 8
    # (gathered away), odd dst pitches
    for dst, kind, sdt in (("u8", "max", None), ("f32", "avg_exc", "s32"),
                           ("s8", "avg_exc", "u8")):
        add(f"lane slices 14x14x64 -> 256 {kind} {dst} sum={sdt}", 1, 14,
            64, 256, 1, dst, kind, "nearest", "down", sdt)
        add(f"odd tiles 22x22 {kind} {dst} sum={sdt}", 1, 22, 32, 96, 1, dst,
            kind, "down", "nearest", sdt)
    for dst, kind in (("u8", "max"), ("f32", "avg_exc")):
        add(f"oc 264 (two passes) {kind} {dst}", 2, 12, 32, 264, 1, dst, kind,
            "nearest", "nearest", None)
        add(f"stride 10 {kind} {dst}", 1, 40, 16, 24, 10, dst, kind,
            "nearest", "nearest", "u8")
        add(f"odd pitch oc 13 {kind} {dst}", 1, 16, 16, 13, 1, dst, kind,
            "nearest", "down", "s32")
    return out


def concat_op_cases(rng, dev, par):
    """K2 through its registered op at inputs the wrapper no longer
    prepares in Python: a 16-byte-misaligned contiguous view, a channel
    slice and a transposed view (non-contiguous), 16 inputs, 17 and 40
    inputs in every dtype (one launch each), 130 inputs (two launches, one
    per group of 128, each writing its columns of the one output), a pixel
    row wider than a block (two inputs of 8,208 u8 channels: each thread
    loops over the row's columns), and the reference's three shape sets at batch 4 in
    every dtype, each bitwise against the plain version with ReLU on and
    off, its launches by the launcher's count and by torch.profiler's
    trace; then the calls the op must refuse:
    a dtype mismatch and mixed devices in its own checks (RuntimeError),
    CPU tensors in the dispatcher (no CPU kernel is registered:
    NotImplementedError)."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.config import ConcatConfig
    from deepfusion_tpu_torch.types import dtype
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    C = importlib.import_module("deepfusion_tpu_torch.ops.concat")
    u8, s8 = dtype.u8, dtype.s8
    nhw = (2, 5, 7)
    numel = math.prod(nhw) * 64
    mis = rand(rng, (numel + 16,), u8, dev)[1:1 + numel].view(nhw + (64,))
    sliced = rand(rng, nhw + (96,), u8, dev)[..., 16:80]
    tposed = rand(rng, (2, 7, 5, 32), s8, dev).transpose(1, 2)
    check(mis.is_contiguous() and mis.data_ptr() % 16 != 0,
          "the misaligned case must be a contiguous misaligned view")
    check(not sliced.is_contiguous() and not tposed.is_contiguous(),
          "the strided cases must be non-contiguous")
    sixteen = [rand(rng, nhw + (16 * (1 + i % 3),), u8, dev)
               for i in range(16)]
    cases = [("misaligned view", [rand(rng, nhw + (32,), u8, dev), mis], u8),
             ("channel slice", [sliced, rand(rng, nhw + (16,), u8, dev)], u8),
             ("transposed view", [tposed, rand(rng, nhw + (64,), s8, dev)],
              s8),
             ("16 inputs", sixteen, u8)]
    for dt in (dtype.u8, dtype.s8, dtype.s32, dtype.f32):
        unit = 16 // dt.size
        for n_in in (17, 40):
            cases.append((f"{n_in} inputs", [
                rand(rng, nhw + (unit * (1 + i % 3),), dt, dev)
                for i in range(n_in)], dt))
        for hw, chans in CONCAT_SETS.items():
            cases.append((f"reference {hw}x{hw}", [
                rand(rng, (4, hw, hw, c), dt, dev) for c in chans], dt))
    cases += [("130 inputs", [rand(rng, nhw + (16,), u8, dev)
                              for _ in range(130)], u8),
              ("a row wider than a block",
               [rand(rng, (2, 3, 5, 8208), u8, dev) for _ in range(2)], u8)]
    for label, xs, dt in cases:
        for relu in (False, True):
            cfg = ConcatConfig.make([tuple(x.shape) for x in xs], dt, relu)
            got, launches, ran = counted_and_traced(
                lambda: C.concat_cuda(xs, cfg), "concat_relu",
                "concat_relu_kernel")
            traced = sum(v for k, v in ran.items()
                         if "concat_relu_kernel" in k)
            check_eq(launches, traced, f"K2's count for {len(xs)} inputs "
                     f"against the kernel launches torch.profiler traced")
            check_eq(launches, -(-len(xs) // 128),
                     f"K2's launches for {len(xs)} inputs")
            par.check("concat_relu", f"{label} {dt.name} relu={relu}",
                      got, C.concat_plain(xs, cfg))
            if relu and (len(xs) > 16 or label.startswith(("reference",
                                                             "a row"))):
                print(f"parity: concat_relu {label} {dt.name}: {launches} "
                      f"launches per call (torch.profiler traced "
                      f"{traced}), bitwise equal to the plain version",
                      flush=True)
    op = _build.op("concat_relu")
    x = sixteen[0]
    for label, args, error in (
            ("a dtype mismatch", [x, x.to(torch.int8)], RuntimeError),
            ("mixed devices", [x, x.cpu()], RuntimeError),
            ("CPU tensors", [x.cpu(), x.cpu()], NotImplementedError)):
        try:
            op(args, True)
        except error as e:
            print(f"parity: concat_relu refused {label}: {type(e).__name__}"
                  f" {str(e).splitlines()[0][:100]}", flush=True)
        else:
            raise AssertionError(f"concat_relu took {label}")


def plan_check(models):
    """conv_plan of every dense conv op of the models (FusionNet,
    ResFusionNet, VGGFusion and ResNet-50 at their default configs) at
    batch 8 and 256 against CONV_PLANS, key for key."""
    from deepfusion_tpu_torch.ops.conv import ConvOp, conv_plan
    from deepfusion_tpu_torch.ops.convpool import ConvPoolOp
    from deepfusion_tpu_torch.utils.logger import check_eq
    with open(CONV_PLANS) as f:
        want = json.load(f)
    seen = 0
    for model in models:
        for name, op in model.named_modules():
            if not isinstance(op, (ConvOp, ConvPoolOp)):
                continue
            for n in (8, 256):
                key = f"{type(model).__name__} {name} {n}"
                got = conv_plan(op, n, pool=isinstance(op, ConvPoolOp))
                check_eq(got, want[key], f"{key}: conv_plan")
                seen += 1
    check_eq(seen, len(want), "plans checked")
    print(f"plans: conv_plan of {seen} (op, batch) pairs of the four models "
          "equal the recorded plans key for key", flush=True)


def phase_parity(net, rnet, vnet, r50, gnet, mnet, dev, sharded) -> Parity:
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    from deepfusion_tpu_torch.config import ConcatConfig, PoolConfig
    from deepfusion_tpu_torch.models.fusionnet import LAYERS
    C = importlib.import_module("deepfusion_tpu_torch.ops.concat")
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    from deepfusion_tpu_torch.types import dtype
    rng = np.random.default_rng(5)
    par = Parity()
    u8 = dtype.u8
    _build.reset_launch_counts()

    # K1: every FusionNet full-width layer, then the extra cases
    for name in LAYERS:
        op = getattr(net, name)
        cfg = op.cfg
        x = rand(rng, (cfg.bs, cfg.ih, cfg.iw, cfg.ic), u8, dev)
        par.check("conv_fused", f"FusionNet {name}", K.conv_cuda(op, x),
                  K.conv_plain(op, x))
    for name in ("stem", "block1", "block2", "head"):
        op = getattr(rnet, name)
        cfg = op.cfg
        x = rand(rng, (cfg.bs, cfg.ih, cfg.iw, cfg.ic), u8, dev)
        sm = rand(rng, (cfg.bs, cfg.oh, cfg.ow, cfg.out_oc), u8, dev) \
            if cfg.with_sum else None
        par.check("conv_fused", f"ResFusionNet {name}",
                  K.conv_cuda(op, x, sm), K.conv_plain(op, x, sm))
    for name, op in [(f"block{b}_conv1", op)
                     for b, op in enumerate(vnet.conv1, 1)] + [
                         ("head", vnet.head)]:
        cfg = op.cfg
        x = rand(rng, (cfg.bs, cfg.ih, cfg.iw, cfg.ic), u8, dev)
        par.check("conv_fused", f"VGGFusion {name}", K.conv_cuda(op, x),
                  K.conv_plain(op, x))
    tiled = []
    ints = {"integer": 0, "f32 fallback": 0}
    for label, op, x, sm in conv_cases(dev):
        par.check("conv_fused", label, K.conv_cuda(op, x, sm),
                  K.conv_plain(op, x, sm))
        if K.tiled_sum(op.cfg):
            plan = K.conv_plan(op, op.cfg.bs)
            tiled.append((plan["split"], plan["passes1"]))
        for path in ints:
            if label.startswith(path):
                ints[path] += 1
                check(K.int_requant(op.cfg) == (path == "integer"),
                      f"{label}: the final stage's path")
    check({sp for sp, n in tiled if n > 1} == {0, 1},
          f"the tiled sum cases must run split and whole tiles, each over "
          f"more than one 1x1 pass: {tiled}")
    print(f"parity: {len(tiled)} K1 cases read the sum as tiles (split, 1x1 "
          f"passes: {sorted(set(tiled))}); at the integer requant's "
          f"sum_scale bound {ints['integer']} cases, past it (the f32 path) "
          f"{ints['f32 fallback']}", flush=True)
    for label, op in k1_geometry_cases(net, dev):
        cfg = op.cfg
        x = rand(rng, (cfg.bs, cfg.ih, cfg.iw, cfg.ic), u8, dev)
        par.check("conv_fused", f"FusionNet {label}", K.conv_cuda(op, x),
                  K.conv_plain(op, x))
        if cfg.fuse_conv1x1:
            par.check("conv_fused", f"acc1 FusionNet {label}",
                      K.conv_cuda(op, x, emit_acc1=True),
                      K.conv_plain(op, x, emit_acc1=True))

    # K9: ResFusionNet's downsample and VGGFusion's conv2+pool of every
    # block at full width, then the extra cases
    CP = importlib.import_module("deepfusion_tpu_torch.ops.convpool")
    for label, op in [("ResFusionNet down", rnet.down)] + [
            (f"VGGFusion block{b}_conv2+pool", op)
            for b, op in enumerate(vnet.convpool2, 1)]:
        c = op.cfg
        x = rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
        par.check("convpool", label, CP.convpool_cuda(op, x),
                  CP.convpool_plain(op, x))
    for label, op, x, sm in convpool_cases(dev):
        par.check("convpool", label, CP.convpool_cuda(op, x, sm),
                  CP.convpool_plain(op, x, sm))

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
    concat_op_cases(rng, dev, par)

    # K3: FusionNet's two pools, ResFusionNet's and VGGFusion's global
    # averages (the last, 49 taps, on pool_kernel), then every dtype and kind
    c = rnet.block2.cfg
    v = vnet.convpool2[-1].cfg
    pcases = [(u8, (8, 56, 56, 256), "max", (2, 2), (2, 2), (0, 0)),
              (u8, (8, 28, 28, 128), "avg_exc", (28, 28), (28, 28), (0, 0)),
              (u8, (c.bs, c.oh, c.ow, c.out_oc), "avg_exc", (c.oh, c.ow),
               (c.oh, c.ow), (0, 0)),
              (u8, (v.bs, v.oh // 2, v.ow // 2, v.out_oc), "avg_exc",
               (v.oh // 2, v.ow // 2), (v.oh // 2, v.ow // 2), (0, 0))]
    for dt in (dtype.u8, dtype.s8, dtype.s32, dtype.f32):
        for kind in ("max", "avg_inc", "avg_exc"):
            pcases += [(dt, (2, 9, 11, 40), kind, (3, 3), (2, 2), (1, 1)),
                       (dt, (2, 9, 9, 24), kind, (2, 2), (2, 2), (0, 0)),
                       (dt, (2, 12, 12, 40), kind, (12, 12), (12, 12),
                        (0, 0))]
    # 16-byte units (c = 16 in 8 bits, every s32 c here), 8-bit rows that
    # are no multiple of 16 bytes (c = 40, 264), strides 1-3 with padding
    for dt in (dtype.u8, dtype.s8, dtype.s32):
        for c in (16, 40, 264):
            for kind in ("max", "avg_inc", "avg_exc"):
                for k, s, p in (((3, 3), (1, 1), (1, 1)),
                                ((3, 3), (2, 2), (1, 1)),
                                ((4, 4), (3, 3), (1, 1))):
                    pcases.append((dt, (2, 8, 10, c), kind, k, s, p))
    # global windows at batch 1: few output units, the split kernel
    for dt, shape, kind in ((u8, (1, 28, 28, 128), "avg_exc"),
                            (u8, (1, 28, 28, 128), "max"),
                            (u8, (1, 7, 7, 256), "avg_exc"),
                            (dtype.s8, (1, 12, 12, 16), "avg_inc")):
        pcases.append((dt, shape, kind, shape[1:3], shape[1:3], (0, 0)))
    # 8-bit inputs at both extremes only, and s32 sums that wrap
    xcases = []
    for dt in (u8, dtype.s8):
        info = np.iinfo(dt.np)
        a = torch.from_numpy(rng.choice([info.min, info.max], (2, 9, 9, 32)
                                        ).astype(dt.np)).to(dev)
        for kind, k, s, p in (("max", (3, 3), (2, 2), (1, 1)),
                              ("avg_inc", (3, 3), (1, 1), (1, 1)),
                              ("avg_exc", (9, 9), (9, 9), (0, 0)),
                              ("max", (9, 9), (9, 9), (0, 0))):
            xcases.append((f"{dt.name} extremes", a, dt, kind, k, s, p))
    big = torch.from_numpy((2 ** 31 - 1 - rng.integers(0, 1000, (
        1, 6, 6, 16))).astype(np.int32)).to(dev)
    for kind, k, s, p in (("avg_inc", (3, 3), (1, 1), (1, 1)),
                          ("avg_exc", (6, 6), (6, 6), (0, 0))):
        xcases.append(("s32 sums that wrap", big, dtype.s32, kind, k, s, p))
    for dt, shape, kind, k, s, p in pcases:
        xcases.append((f"{dt.name} {shape}", rand(rng, shape, dt, dev), dt,
                       kind, k, s, p))
    for what, x, dt, kind, k, s, p in xcases:
        for rnd in (("nearest", "down") if kind != "max" and dt.is_int
                    else ("nearest",)):
            pc = PoolConfig.make(kind, tuple(x.shape[1:3]), k, s, p, rnd)
            par.check("pool", f"{what} {kind} k{k} s{s} p{p} {rnd}",
                      P.pool_cuda(x, pc, dt), P.pool_plain(x, pc, dt))

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
    packed_parity(net, rnet, dev, par)
    pair_parity(vnet, dev, par)
    composed_parity(net, rnet, vnet, dev, par)
    acc1_parity(net, dev, par)
    range_parity(vnet, dev, par)
    resnet50_parity(r50, dev, par)
    googlenet_parity(gnet, dev, par)
    mobilenetv2_parity(mnet, dev, par)
    sharded_parity(sharded, par)
    for k in KERNEL_INFO:
        print(f"parity: {k} bitwise equal to its plain version in "
              f"{par.cases[k]} cases, max_abs_err {par.err[k]}", flush=True)
    for m, c in _build.mode_counts().items():
        print(f"parity: mode {m} launched {c} times, each launch held "
              "against its plain version", flush=True)
    return par


def resnet50_parity(r50, dev, par):
    """K1 at every conv of ResNet50(ResNet50Config()) (224x224, its batch)
    on full-range random inputs and sum operands: the 7x7/s2 stem on 3
    channels (a 7x1 conv over its seven column taps folded into 32
    channels by the unfold kernel), the 1x1 reduces over 64-2048
    channels, the 1x1 projections to s8 at strides 1 and 2, the 16 fused
    3x3 + 1x1 expands with the u8 (identity) or s8 (projection) sum at
    strides 1 and 2, up to a 512-lane intermediate and 2048 output lanes,
    and the f32 head; K3 at its floor-mode 3x3/s2/p1 max pool (112 -> 56)
    and its 7x7x2048 global average; the unfold kernel against its plain
    version at the stem's shape at batch 8 and 256 and at 4 channels under
    a 3x5 kernel at column stride 1, and the stem at batch 256 (unfold and
    K1) against the plain conv; then one eager forward on the model's
    example input with every K1 and K3 launch held against its plain
    version (the calibrated activations and the real shortcuts)."""
    from deepfusion_tpu_torch.config import PoolConfig
    from deepfusion_tpu_torch.types import dtype
    from deepfusion_tpu_torch.utils.logger import check_eq
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    rng = np.random.default_rng(50)
    u8 = dtype.u8
    for name, op in r50.convs.items():
        c = op.cfg
        x = rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
        sm = rand(rng, (c.bs, c.oh, c.ow, c.out_oc), c.sum_dt, dev) \
            if c.with_sum else None
        what = f"ResNet50 {name}" + (f" sum {c.sum_dt.name}" if sm is not None
                                     else "")
        par.check("conv_fused", what, K.conv_cuda(op, x, sm),
                  K.conv_plain(op, x, sm))
    stem = r50.convs["stem"].cfg
    last = list(r50.convs.values())[-2].cfg      # the last fused block
    for what, shape, kind, k, s, p in (
            ("ResNet50 max pool", (stem.bs, stem.oh, stem.ow, stem.oc), "max",
             (3, 3), (2, 2), (1, 1)),
            ("ResNet50 global avg", (last.bs, last.oh, last.ow, last.out_oc),
             "avg_exc", (last.oh, last.ow), (last.oh, last.ow), (0, 0))):
        x = rand(rng, shape, u8, dev)
        pc = PoolConfig.make(kind, shape[1:3], k, s, p, ceil_mode=False)
        got = P.pool_cuda(x, pc, u8)
        check_eq(tuple(got.shape[1:3]), (shape[1] // s[0], shape[2] // s[1]),
                 f"{what}: floor-mode output size")
        par.check("pool", what, got, P.pool_plain(x, pc, u8))
    unfold_parity(r50.convs["stem"], rng, dev, par)
    x = torch.from_numpy(r50.example_input()).to(dev)
    before = par.cases["conv_fused"]
    with held_against_plain(par, "ResNet50 eager forward"):
        r50(x)
    check_eq(par.cases["conv_fused"] - before, len(r50.convs),
             "ResNet50 eager forward: K1 launches held against the plain "
             "version")
    print(f"parity: ResNet50 {len(r50.convs)} convs on full-range inputs, "
          f"its two pools and one eager forward's {len(r50.convs)} K1 "
          f"launches at batch {stem.bs}, bitwise equal to the plain "
          "versions", flush=True)


def googlenet_parity(gnet, dev, par):
    """At GoogLeNet(GoogLeNetConfig())'s batch and again at the offline
    cell's batch, 256 (whose K1 plans take other tiles, splits and item
    counts, and whose K2 and K3 grids differ): K1 at every conv (224x224)
    on full-range random inputs: the 7x7/s2 stem over its unfolded column
    taps, the 1x1s to 16-384 lanes (16, 24, 48, 96, 112, 144, 208, 224 and
    288 no multiple of 64) over 64-832 channels (528 padded to the
    k-step), the 3x3s over 64-192 channels, the 5x5/p2s over 16-48 (24
    padded to 32) and the f32 head; K3 at its three pool kinds (the
    ceil-mode 3x3/s2 max pools at 112, 56, 28 and 14, the 3x3/s1/p1 branch
    pool at each module's input, the 7x7x1024 global average); K2 at each
    module's concat of its four u8 branches (256-1,024 lanes); then one
    eager forward on full-range images with every K1, K2 and K3 launch
    held against its plain version."""
    from deepfusion_tpu_torch.config import ConcatConfig, PoolConfig
    from deepfusion_tpu_torch.models.googlenet import (MODULES,
                                                       POOLED_BEFORE, pooled)
    from deepfusion_tpu_torch.types import dtype
    from deepfusion_tpu_torch.utils.logger import check_eq
    C = importlib.import_module("deepfusion_tpu_torch.ops.concat")
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    rng = np.random.default_rng(1409)
    u8 = dtype.u8
    convs = gnet.convs

    def out_hw(name):
        c = convs[name].cfg
        return (c.oh, c.ow, c.oc)
    # the 3x3/s2 pools' inputs: the stem's, conv2's, and the module output
    # before 4a and 5a; each module's input, which its branch pool reads
    s2 = [out_hw("stem"), out_hw("conv2")]
    s1 = []
    prev = None
    for m, *_ in MODULES:
        c = convs[f"{m}_1x1"].cfg
        if m in POOLED_BEFORE:
            p = convs[f"{prev}_1x1"].cfg
            s2.append((p.ih, p.iw, c.ic))
        s1.append((c.ih, c.iw, c.ic))
        prev = m
    last, g = convs["head"].cfg, convs[f"{prev}_1x1"].cfg
    pools = [("3x3/s2 ceil", hwc, (3, 3), (2, 2), (0, 0), "max")
             for hwc in s2]
    pools += [("3x3/s1/p1 branch", hwc, (3, 3), (1, 1), (1, 1), "max")
              for hwc in s1]
    pools.append(("global avg", (g.ih, g.iw, last.ic), (g.ih, g.iw),
                  (g.ih, g.iw), (0, 0), "avg_exc"))
    batches = (last.bs, 256)
    for n in batches:
        for name, op in convs.items():
            c = op.cfg
            x = rand(rng, (n, c.ih, c.iw, c.ic), u8, dev)
            par.check("conv_fused", f"GoogLeNet {name} b{n}",
                      K.conv_cuda(op, x), K.conv_plain(op, x))
            del x
        for what, hwc, k, s, p, kind in pools:
            x = rand(rng, (n, *hwc), u8, dev)
            pc = PoolConfig.make(kind, hwc[:2], k, s, p)
            got = P.pool_cuda(x, pc, u8)
            want_hw = {(2, 2): pooled(hwc[0]), (1, 1): hwc[0]}.get(s, 1)
            check_eq(got.shape[1], want_hw,
                     f"GoogLeNet {what} {hwc} b{n}: size")
            par.check("pool", f"GoogLeNet {what} {hwc} b{n}", got,
                      P.pool_plain(x, pc, u8))
        for m, *_ in MODULES:
            xs = [rand(rng, (n, *out_hw(f"{m}_{b}")), u8, dev)
                  for b in ("1x1", "3x3", "5x5", "pool_proj")]
            cc = ConcatConfig.make([tuple(x.shape) for x in xs], torch.uint8,
                                   False)
            got = C.concat_cuda(xs, cc)
            par.check("concat_relu",
                      f"GoogLeNet {m} concat {tuple(got.shape)}", got,
                      C.concat_plain(xs, cc))
        x = rand(rng, (n, gnet.cfg.hw, gnet.cfg.hw, gnet.cfg.in_ch), u8, dev)
        before = dict(par.cases)
        with held_against_plain(par, f"GoogLeNet eager forward b{n}"):
            gnet(x)
        check_eq({k: par.cases[k] - before[k] for k in
                  ("conv_fused", "concat_relu", "pool")},
                 {"conv_fused": len(convs), "concat_relu": len(MODULES),
                  "pool": len(pools)},
                 f"GoogLeNet eager forward b{n}: launches held against the "
                 "plain versions")
        del x
        torch.cuda.empty_cache()
    print(f"parity: GoogLeNet at batch {batches[0]} and {batches[1]}, each: "
          f"{len(convs)} convs on full-range inputs, {len(pools)} pools of "
          f"three kinds, {len(MODULES)} concats and one eager forward's "
          f"{len(convs)} K1, {len(MODULES)} K2 and {len(pools)} K3 "
          "launches, bitwise equal to the plain versions", flush=True)


def mobilenetv2_parity(mnet, dev, par):
    """At MobileNetV2(MobileNetV2Config())'s batch and again at the offline
    cell's 256: K1 at every dense conv (224x224) on full-range random
    inputs: the 3x3/s2 stem over its unfolded column taps, the 16 expands
    and the last 1x1 over full-range s8 sources (the s8-source kernel), the
    17 projections into s8, 10 of them with a full-range s8 sum operand,
    and the f32 head; the depthwise kernel at its 17 layers (3x3 at stride
    1 and 2 over 32-960 channels, 112x112 to 7x7); K3 at the 7x7x1280
    global average; then one eager forward on full-range images with every
    K1, depthwise and K3 launch held against its plain version, its logits
    bitwise equal to the benchmark's plain reference's on the same
    weights."""
    from deepfusion_tpu_torch.config import PoolConfig
    from deepfusion_tpu_torch.types import dtype
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    from portbench import harness
    from portbench.reference import mobilenetv2 as ref
    D = importlib.import_module("deepfusion_tpu_torch.ops.depthwise")
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    rng = np.random.default_rng(1801)
    u8 = dtype.u8
    n_conv = sum(l.kind != "depthwise" for l in mnet.plan)
    n_dw = len(mnet.plan) - n_conv
    last = mnet.ops["last"].cfg
    batches = (mnet.cfg.batch, 256)
    for n in batches:
        for layer in mnet.plan:
            op = mnet.ops[layer.name]
            if layer.kind == "depthwise":
                c = op.cfg
                x = rand(rng, (n, c.ih, c.iw, c.c), u8, dev)
                par.check("depthwise", f"MobileNetV2 {layer.name} b{n}",
                          D.depthwise_cuda(op, x), D.depthwise_plain(op, x))
                continue
            c = op.cfg
            x = rand(rng, (n, c.ih, c.iw, c.ic), c.src_dt, dev)
            sm = rand(rng, (n, c.oh, c.ow, c.out_oc), c.sum_dt, dev) \
                if c.with_sum else None
            par.check("conv_fused", f"MobileNetV2 {layer.name} b{n} src "
                      f"{c.src_dt.name}" + (" sum s8" if sm is not None
                                            else ""),
                      K.conv_cuda(op, x, sm), K.conv_plain(op, x, sm))
            del x, sm
        x = rand(rng, (n, last.oh, last.ow, last.out_oc), u8, dev)
        pc = PoolConfig.make("avg_exc", (last.oh, last.ow), (last.oh,
                                                             last.ow),
                             (last.oh, last.ow), (0, 0))
        par.check("pool", f"MobileNetV2 global avg b{n}",
                  P.pool_cuda(x, pc, u8), P.pool_plain(x, pc, u8))
        x = rand(rng, (n, mnet.cfg.hw, mnet.cfg.hw, mnet.cfg.in_ch), u8, dev)
        before = dict(par.cases)
        with held_against_plain(par, f"MobileNetV2 eager forward b{n}"):
            got = mnet(x)
        check_eq({k: par.cases[k] - before[k] for k in
                  ("conv_fused", "depthwise", "pool")},
                 {"conv_fused": n_conv, "depthwise": n_dw, "pool": 1},
                 f"MobileNetV2 eager forward b{n}: launches held against the "
                 "plain versions")
        want = harness.reference_logits(ref, mnet.params, x)
        check(np.array_equal(got.cpu().numpy().view(np.uint32),
                             want.view(np.uint32)),
              f"MobileNetV2 b{n}: logits differ from the plain reference's")
        del x, got
        torch.cuda.empty_cache()
    print(f"parity: MobileNetV2 at batch {batches[0]} and {batches[1]}, "
          f"each: {n_conv} dense convs and {n_dw} depthwise layers on "
          f"full-range inputs, its global average, one eager forward's "
          f"{n_conv} K1, {n_dw} depthwise and 1 K3 launches, bitwise equal "
          "to the plain versions, and its logits to the plain reference's",
          flush=True)


def unfold_parity(stem, rng, dev, par):
    """The unfold kernel (``unfold_cols_cuda``) bitwise against its plain
    version at ResNet-50's stem (3 channels, 7 taps at column stride 2 and
    padding 3, 224 -> 112 columns) at batch 8 and 256 and at 4 channels
    under a 3x5 kernel at column stride 1 (padding 2, 37 columns, 20 real
    bytes of 32); then the stem at batch 256 through the unfolded path (its
    unfold and K1 launch) against the plain conv."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.config import ConvConfig
    from deepfusion_tpu_torch.ops.conv import ConvOp
    from deepfusion_tpu_torch.types import dtype
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    c = stem.cfg
    check(K.unfold_cols(c), "ResNet50 stem: the column taps unfold")
    odd = ConvConfig.make((3, 9, 37, 4), (16, 4, 3, 5), None, (1, 1),
                          (1, 2), (3, 9, 37, 16), "u8",
                          conv0_scales=(1 / 300,))
    check(K.unfold_cols(odd), "ic 4 under 3x5: the column taps unfold")
    for what, cfg, n in (("ResNet50 stem b8", c, 8),
                         ("ResNet50 stem b256", c, 256),
                         ("ic 4, 3x5, column stride 1", odd, 3)):
        x = rand(rng, (n, cfg.ih, cfg.iw, cfg.ic), dtype.u8, dev)
        geo = K._unfold_geo(cfg)
        par.check("unfold_cols", what, K.unfold_cols_cuda(x, geo),
                  K.unfold_cols_plain(x, geo))
    w = rng.integers(-128, 128, (16, 4, 3, 5)).astype(np.int8)
    x = rand(rng, (3, 9, 37, 4), dtype.u8, dev)
    op = ConvOp(odd, w, device=dev)
    par.check("conv_fused", "ic 4, 3x5, column stride 1, unfolded",
              K.conv_cuda(op, x), K.conv_plain(op, x))
    x = rand(rng, (256, c.ih, c.iw, c.ic), dtype.u8, dev)
    before = _build.mode_counts()["conv_fused.unfold"]
    par.check("conv_fused", "ResNet50 stem b256 unfolded",
              K.conv_cuda(stem, x), K.conv_plain(stem, x))
    check_eq(_build.mode_counts()["conv_fused.unfold"] - before, 1,
             "ResNet50 stem b256: K1 launches over unfolded column taps")
    print("parity: unfold_cols at the ResNet50 stem (batch 8 and 256) and "
          "at ic 4 under 3x5; the stem at batch 256 and the ic-4 conv "
          "through the unfolded path; all bitwise equal to the plain "
          "versions", flush=True)


def packed_conv_cases(dev):
    """(label, PackedConvOp, batch, junk pads) for the extra K5 cases."""
    rng = np.random.default_rng(12)
    out = []

    def add(label, *a, n=2, junk=False, **kw):
        out.append((label, packed_conv_op(rng, *a, dev=dev, n=n, **kw), n,
                    junk))

    for rnd in ("nearest", "down"):
        add(f"3x3 {rnd}", 12, [64], 64, rnd=rnd)
        add(f"fused {rnd}", 12, [64], 96, oc1=64, rnd=rnd)
    add("no-bias scalar-scale", 10, [32], 64, bias=False, per_oc=False)
    add("fused no-bias scalar-scale", 10, [32], 32, oc1=32, bias=False,
        per_oc=False)
    add("c=40 oc=40 (pad lanes)", 11, [40], 40)
    add("fused oc=72 oc1=40 (pad lanes)", 11, [40], 72, oc1=40)
    for d in (0, 1, 2):
        add(f"halo delta {d}", 12, [32], 32, halo_in=1 + d, halo_out=1)
    add("col_off 1 -> 6 (|d| >= 4)", 12, [32], 32, halo_in=3,
        off_in=1, off_out=6, iwp=32)
    add("col_off 6 -> 1 (|d| >= 4)", 12, [32], 32, halo_in=3,
        off_in=6, off_out=1, iwp=32)
    add("5x5", 12, [32], 32, k=5, halo_in=3, halo_out=2, off_in=2,
        off_out=2)
    add("1x1 three inputs", 9, [32, 64, 48], 64, k=1)
    add("3x3 two inputs fused", 9, [64, 64], 128, oc1=64)
    add("fused oc0=544 (two channel passes)", 5, [32], 544, oc1=40, n=1)
    add("junk pads 3x3", 12, [64], 64, junk=True)
    add("junk pads fused two inputs", 12, [32, 48], 64, oc1=32, junk=True)
    add("junk pads 5x5", 12, [40], 40, k=5, halo_in=3, junk=True)
    # the packed sum operand at halo differences 0 and 1, fused and not,
    # both round modes, with valid and with random pad bytes
    for d in (0, 1):
        for oc1 in (None, 40):
            for rnd in ("nearest", "down"):
                for junk in (False, True):
                    add(f"sum halo+{d} fused={oc1 is not None} {rnd} "
                        f"junk={junk}", 12, [64], 72, oc1=oc1, rnd=rnd,
                        halo_in=2, halo_out=1, sum_halo=1 + d,
                        sum_scale=0.8 if d else 1.0, junk=junk)
    # the fused 2x2 pool (pool2): fused and not, both round modes, with and
    # without the sum operand, valid and random pad bytes, output halo 2
    # and 0
    for oc1 in (None, 40):
        for rnd in ("nearest", "down"):
            for sum_halo in (None, 3):
                for junk in (False, True):
                    add(f"pool2 fused={oc1 is not None} {rnd} "
                        f"sum={sum_halo is not None} junk={junk}", 12, [64],
                        72, oc1=oc1, rnd=rnd, halo_in=3, halo_out=2,
                        iwp=16, sum_halo=sum_halo, sum_scale=0.8, junk=junk,
                        pool2=True)
    add("pool2 halo_out 0", 14, [32], 64, halo_in=1, halo_out=0, iwp=32,
        pool2=True)
    # the kernel's 16 x 8 output tiles: oh and ow no multiple of 16 or 8,
    # batch 1 and 3, fused and not, with random pad bytes
    add("tile edges 19x13 batch 1", (19, 13), [64], 64, n=1, junk=True)
    add("tile edges 21x11 batch 3 fused", (21, 11), [32], 64, oc1=32, n=3,
        junk=True)
    add("tile edges 37x9 batch 1 fused sum", (37, 9), [64], 64, oc1=40,
        n=1, sum_halo=2, sum_scale=0.8, junk=True)
    # four inputs, one of 16 lanes (each input's lanes padded to 32 K bytes)
    add("four inputs, one of 16 lanes", 10, [32, (16, 16), 64, (48, 48)],
        64, junk=True)
    add("fused four inputs, one of 16 lanes", 10,
        [(16, 16), 64, 32, (48, 48)], 72, oc1=40, junk=True)
    # the narrowest lane passes: oc0p 32 unfused and fused
    add("oc0p 32 (oc 24)", 11, [32], 24, junk=True)
    add("fused oc0p 32 (oc 32, oc1 24)", 11, [64], 32, oc1=24, junk=True)
    # 5x5 with the fused pool
    for oc1 in (None, 40):
        add(f"5x5 pool2 fused={oc1 is not None}", 12, [32], 64, k=5,
            oc1=oc1, halo_in=3, halo_out=2, iwp=16, pool2=True, junk=True)
    # the residual merge and pool (merge_pool: a 1x1 whose output lanes are
    # its inputs', their geometry kept): FusionNet's widths, chunks of 64
    # and 32 bytes (their swizzles), three inputs, two lane passes, tile
    # edges, a deeper halo; scales that clamp at both ends and saturate
    for junk in (False, True):
        add(f"merge_pool 128 + 128 junk={junk}", 12, [128, 128], 256, k=1,
            halo_in=2, halo_out=2, iwp=16, merge_pool=True, sc=1 / 300,
            junk=junk)
    add("merge_pool 96 + 32", 12, [96, 32], 128, k=1, halo_in=2,
        halo_out=2, iwp=16, merge_pool=True, sc=1 / 300, junk=True)
    add("merge_pool 32 + 64 + 32", 12, [32, 64, 32], 128, k=1, halo_in=2,
        halo_out=2, iwp=16, merge_pool=True, sc=1 / 300, junk=True)
    add("merge_pool 256 + 128 (two lane passes)", 12, [256, 128], 384,
        k=1, halo_in=2, halo_out=2, iwp=16, merge_pool=True, sc=1 / 300,
        junk=True)
    add("merge_pool tile edges 22x10 batch 3", (22, 10), [64, 64], 128,
        k=1, halo_in=2, halo_out=2, iwp=16, n=3, merge_pool=True,
        sc=1 / 300, junk=True)
    add("merge_pool halo 4 col_off 4", 12, [64], 64, k=1, halo_in=4,
        halo_out=4, off_in=4, off_out=4, iwp=32, merge_pool=True,
        sc=1 / 300, junk=True)
    # C13: more inputs than the kernel takes and lane widths no multiple
    # of 16, joined into the kernel's inputs (ops/packed.py kernel_groups)
    add("C13 five inputs of 32", 28, [32] * 5, 64, n=8, junk=True)
    add("C13 fused five inputs of 32", 28, [32] * 5, 64, oc1=64, n=8)
    add("C13 8 + 24 lanes", 28, [(8, 8), (24, 24)], 64, n=8, junk=True)
    add("C13 six mixed widths", 28, [(8, 8), (8, 8), (16, 16), (32, 32),
                                     (24, 24), (8, 8)], 64, n=8)
    add("C13 fused six mixed widths", 28, [(8, 8), (8, 8), (16, 16),
                                           (32, 32), (16, 16), (8, 16)],
        72, oc1=40, n=8, junk=True)
    # the same at FusionNet's batch, side and widths
    for label, hw, cs, oc, junk, kw in C13_CONVS:
        add(label, hw, cs, oc, n=8, junk=junk, **kw)
    return out


def pair_cases(dev):
    """(label, PackedConvPairOp, batch, junk pads) for the extra K10
    cases: every fused combination with and without the pool, a channel
    change, round-down per-oc scales, deeper and shallower input halos."""
    from deepfusion_tpu_torch.config import ConvConfig
    from deepfusion_tpu_torch.ops.mega import PackedConvPairOp
    from deepfusion_tpu_torch.ops.packed import PackedSpec
    rng = np.random.default_rng(14)
    out = []

    def layer(n, hw, ic, oc, oc1=None, rnd="nearest", per_oc=True):
        wei = rng.integers(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
        bia = rng.integers(-5000, 5000, (oc,)).astype(np.int32)
        sc = 1.0 / (9 * ic * 60)
        kw = {}
        wei1 = bia1 = None
        if oc1 is not None:
            wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
            bia1 = rng.integers(-5000, 5000, (oc1,)).astype(np.int32)
            kw = dict(wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=np.int32,
                      conv1_relu=True, conv1_round=rnd,
                      conv1_scales=(rng.uniform(0.5, 1.5, oc1) / (oc * 60)
                                    ).astype(np.float32) if per_oc
                      else (1.0 / (oc * 60),))
        cfg = ConvConfig.make(
            (n, hw, hw, ic), (oc, ic, 3, 3), np.int32, (1, 1), (1, 1),
            (n, hw, hw, oc1 or oc), "u8", conv0_relu=True, conv0_round=rnd,
            conv0_scales=(rng.uniform(0.5, 1.5, oc) * sc).astype(np.float32)
            if per_oc else (sc,), **kw)
        return cfg, (wei, bia, wei1, bia1)

    def add(label, n, hw, a, b, junk=True, **kw):
        (ca, wa), (cb, wb) = layer(n, hw, *a), layer(n, hw, *b)
        out.append((label, PackedConvPairOp(ca, wa, cb, wb, device=dev,
                                            **kw), n, junk))

    sin = PackedSpec.make(12, 12, 32, halo=2, col_off=2, iwp=16)
    for fa in (None, 48):
        for fb in (None, 40):
            for pool2 in (False, True):
                add(f"fused_a={fa is not None} fused_b={fb is not None} "
                    f"pool2={pool2}", 2, 12, (32, 64, fa), (fa or 64, 64, fb),
                    sin=sin, halo_out=2, col_off_out=2, pool2=pool2)
    add("channel change 32 -> 48 -> 1x1 96 -> 128 -> 1x1 32", 2, 10,
        (32, 48, 96), (96, 128, 32), junk=False)
    add("round down, per-oc scales", 2, 12, (32, 64, 32, "down"),
        (32, 64, 32, "down"), sin=sin, halo_out=2, col_off_out=2,
        pool2=True)
    add("scalar scales", 1, 9, (32, 32, None, "nearest", False),
        (32, 32, None, "nearest", False))
    add("deep input halo 3 -> 1", 2, 12, (32, 64), (64, 64),
        sin=PackedSpec.make(12, 12, 32, halo=3, col_off=1), halo_out=1)
    add("shallow input halo 1 -> 2 (tests/test_mega.py:322)", 1, 4,
        (32, 32), (32, 32), sin=PackedSpec.make(4, 4, 32, halo=1, col_off=1,
                                                iwp=16),
        halo_out=2, col_off_out=2)
    add("oc 544 (two channel passes)", 1, 6, (32, 544), (544, 64))
    # the wgmma kernel's tile edges (pair_conv_plan): a block 3-sized split
    # tile, an odd tile count with partial last tiles in both directions,
    # the wide tile (layer b's 32 lanes cannot split) with pool2, and a
    # wide fused pair
    add("block3-sized 14x14 128 -> 256 -> 256 pool2", 2, 14, (128, 256),
        (256, 256), sin=PackedSpec.make(14, 14, 128, halo=2, col_off=2,
                                        iwp=32),
        halo_out=2, col_off_out=2, pool2=True)
    add("odd tiles 20x20 split", 1, 20, (32, 64), (64, 64))
    add("odd tiles 20x20 wide pool2", 1, 20, (32, 64), (64, 32),
        sin=PackedSpec.make(20, 20, 32, halo=2, col_off=2, iwp=32),
        halo_out=2, col_off_out=2, pool2=True)
    add("wide fused 18x18 64 -> 64 -> 1x1 32 -> 32 -> 1x1 64", 2, 18,
        (64, 64, 32), (32, 32, 64))
    return out


def packed_parity(net, rnet, dev, par):
    """K5 at every packed FusionNet and ResFusionNet layer (valid and junk
    pads; the s2d stem, the sum operand) and the extra cases; K6/K7/K8 at
    FusionNet's residual shape, K7 at ResFusionNet's pool, 1-3 inputs,
    edges."""
    from deepfusion_tpu_torch.ops import packed as PK
    from deepfusion_tpu_torch.ops.packed import PackedSpec
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    rng = np.random.default_rng(6)
    P = net.build_packed()
    n = net.cfg.batch
    cases = [(f"FusionNet {name}", op, n) for name, op in P.items()]
    cases += [(f"ResFusionNet {name}", op, rnet.cfg.batch)
              for name, op in rnet.build_packed().items()]
    for label, op, bn in cases:
        for junk in (False, True):
            arrs = [packed_input(rng, s, bn, dev, junk) for s in op.sins]
            sm = None if op.ssum is None else \
                packed_input(rng, op.ssum, bn, dev, junk)
            par.check("packed_conv", f"{label} junk={junk}",
                      PK.packed_conv_cuda(op, arrs, sm),
                      PK.packed_conv_plain(op, arrs, sm))
    for label, op, bn, junk in packed_conv_cases(dev):
        arrs = [packed_input(rng, s, bn, dev, junk) for s in op.sins]
        sm = None if op.ssum is None else \
            packed_input(rng, op.ssum, bn, dev, junk)
        par.check("packed_conv", label, PK.packed_conv_cuda(op, arrs, sm),
                  PK.packed_conv_plain(op, arrs, sm))

    r = P["res"].sout
    yspecs = [P["block1"].sout, P["branch"].sout]
    cases = [("FusionNet residual", yspecs, r, n)]
    for cs in ([64], [32, 32], [32, 64, 32]):
        ys = [PackedSpec.make(6, 10, c, halo=2, col_off=2, iwp=16)
              for c in cs]
        cases.append((f"{cs}", ys, PackedSpec.make(
            6, 10, sum(cs), halo=2, col_off=2, iwp=16), 2))
    cases += c13_sum_pool_cases()
    for label, ys_s, rs, bn in cases:
        for junk in (False, True):
            ys = [packed_input(rng, s, bn, dev, junk) for s in ys_s]
            rr = packed_input(rng, rs, bn, dev, junk)
            for sum_, pool in ((True, True), (True, False), (False, True)):
                if not sum_ and len(ys) > 1:
                    continue
                what = f"{label} junk={junk} sum={sum_} pool={pool}"
                args = (ys, rr if sum_ else None, pool, rs.rows, rs.iwp)
                if not sum_:
                    par.check("packed_sum_pool", what,
                              PK.packed_sum_pool_cuda(*args),
                              PK.packed_sum_pool_plain(*args))
                    continue
                # the sums: the inputs as they are, one launch per group of
                # 128 inputs and no other kernel (no join, no pad) in the call
                got, launches, ran = counted_and_traced(
                    lambda: PK.packed_sum_pool_cuda(*args), "packed_sum_pool",
                    "packed_sum_pool_kernel")
                check(all("packed_sum_pool_kernel" in k for k in ran),
                      f"packed_sum_pool {what}: other kernels ran in the "
                      f"call: {sorted(ran)}")
                check_eq((launches, sum(ran.values())),
                         (-(-len(ys) // 128),) * 2,
                         f"packed_sum_pool {what}: launches by the count "
                         f"and by torch.profiler")
                par.check("packed_sum_pool", what, got,
                          PK.packed_sum_pool_plain(*args))
                if label.startswith("C13") and junk:
                    print(f"parity: packed_sum_pool {what}: {launches} "
                          f"launch(es), no other kernel traced, bitwise "
                          f"equal to the plain version", flush=True)
    # K7 alone: ResFusionNet's packed max pool after its downsample conv,
    # at batch 8 and 1; rows whose two input rows exceed one block's chunk
    # (32 KB): two column chunks, the last one short, and three; odd
    # numbers of output rows
    ds = rnet.build_packed()["down"].sout
    cases = [("ResFusionNet down", ds, rnet.cfg.batch),
             ("ResFusionNet down n=1", ds, 1),
             ("2 chunks", PackedSpec.make(6, 70, 256, halo=2, col_off=2,
                                          iwp=80), 2),
             ("3 chunks", PackedSpec.make(4, 40, 1024, halo=2, col_off=2,
                                          iwp=48), 1),
             ("5 output rows", PackedSpec.make(6, 10, 64, halo=2, col_off=2,
                                               iwp=16), 3),
             ("9 output rows", PackedSpec.make(14, 20, 128, halo=2,
                                               col_off=2, iwp=32), 2)]
    for label, s, bn in cases:
        for junk in (False, True):
            y = packed_input(rng, s, bn, dev, junk)
            args = ([y], None, True, s.rows, s.iwp)
            par.check("packed_sum_pool", f"{label} pool junk={junk}",
                      PK.packed_sum_pool_cuda(*args),
                      PK.packed_sum_pool_plain(*args))
    # saturation edges: every (a, b) byte pair of -128, -1, 0, 127
    edge = torch.tensor([-128, -1, 0, 127], dtype=torch.int8)
    a = edge.repeat_interleave(4).repeat(16).reshape(1, 16, 16).to(dev)
    b = edge.repeat(4).repeat(16).reshape(1, 16, 16).to(dev)
    for pool in (False, True):
        par.check("packed_sum_pool", f"edges pool={pool}",
                  PK.packed_sum_pool_cuda([a], b, pool, 2, 8),
                  PK.packed_sum_pool_plain([a], b, pool, 2, 8))


def pair_parity(vnet, dev, par):
    """K10 at each of VGGFusion's three full-width pairs (valid and junk
    pads), then the extra cases; and the same three blocks as a packed conv
    then a packed conv with K5's fused pool, against the pair's plain
    version (K5 pool2 at full width)."""
    from deepfusion_tpu_torch.ops import mega as M
    from deepfusion_tpu_torch.ops import packed as PK
    rng = np.random.default_rng(15)
    n = vnet.cfg.batch
    for b, pair in enumerate(vnet.build_packed(), 1):
        for junk in (False, True):
            x = packed_input(rng, pair.sin, n, dev, junk)
            want = M.pair_conv_plain(pair, x)
            par.check("pair_conv", f"VGGFusion block{b} junk={junk}",
                      M.pair_conv_cuda(pair, x), want)
            mid = PK.packed_conv_cuda(pair.op_a, [x])
            par.check("packed_conv", f"VGGFusion block{b} conv a, conv b "
                      f"pool2 junk={junk}",
                      PK.packed_conv_cuda(pair.op_b, [mid]), want)
    for label, pair, bn, junk in pair_cases(dev):
        x = packed_input(rng, pair.sin, bn, dev, junk)
        par.check("pair_conv", label, M.pair_conv_cuda(pair, x),
                  M.pair_conv_plain(pair, x))


def composed_parity(net, rnet, vnet, dev, par):
    """The kernels at the shapes tools/kernel_times.py times them at, and
    beside what it times them against: FusionNet's res with merge_pool at
    batch 8 and 256 against its plain version; K9 at ResFusionNet's
    downsample and VGGFusion's three conv2+pool layers against K1 then K3's
    2x2 max pool; each VGGFusion block's pair against packed conv a then
    packed conv b with K5's pool2, and then K7; bench.py's default (K5),
    --dense (K1) and --pair (K10) shapes against their plain versions."""
    from deepfusion_tpu_torch.ops import mega as M
    from deepfusion_tpu_torch.ops import packed as PK
    from deepfusion_tpu_torch.ops.packed import PackedConvOp
    from deepfusion_tpu_torch.types import dtype
    CP = importlib.import_module("deepfusion_tpu_torch.ops.convpool")
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    P = importlib.import_module("deepfusion_tpu_torch.ops.pool")
    rng = np.random.default_rng(19)
    u8 = dtype.u8
    res = net.build_packed()["res"]
    for bn in (8, 256):
        xs = [packed_input(rng, s, bn, dev) for s in res.sins]
        par.check("packed_conv", f"FusionNet res merge_pool batch {bn}",
                  PK.packed_conv_cuda(res, xs), PK.packed_conv_plain(res, xs))
        del xs
    for label, op, p in [("ResFusionNet down", rnet.down,
                          rnet.params["down"])] + [
            (f"VGGFusion block{b} conv2+pool", op,
             vnet.params[f"block{b}_conv2"])
            for b, op in enumerate(vnet.convpool2, 1)]:
        c = op.cfg
        x = rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
        cop = K.ConvOp(c, p["wei"], p.get("bia"), device=dev)
        par.check("convpool", f"{label} against conv_fused then pool",
                  CP.convpool_cuda(op, x),
                  P.pool_cuda(K.conv_cuda(cop, x), op.pc, u8))
    for b, pair in enumerate(vnet.build_packed(), 1):
        x = packed_input(rng, pair.sin, vnet.cfg.batch, dev)
        p2 = vnet.params[f"block{b}_conv2"]
        op_b = PackedConvOp(pair.cfg_b, p2["wei"], p2.get("bia"),
                            sin=pair.op_b.sin, col_off_out=pair.sout.col_off,
                            halo_out=pair.sout.halo, device=dev)
        mid = PK.packed_conv_cuda(pair.op_a, [x])
        want = M.pair_conv_cuda(pair, x)
        par.check("pair_conv", f"VGGFusion block{b} against packed conv a, "
                  "packed conv b, K7 pool", want, PK.packed_maxpool2(
                      PK.packed_conv_cuda(op_b, [mid]), pair.sout)[0])
        par.check("pair_conv", f"VGGFusion block{b} against packed conv a, "
                  "packed conv b with pool2", want,
                  PK.packed_conv_cuda(pair.op_b, [mid]))
    fop, fb, _ = flagship_op(dev)
    fx = packed_input(rng, fop.sin, fb, dev)
    par.check("packed_conv", "bench.py default 8x126x126x256 fused",
              PK.packed_conv_cuda(fop, [fx]), PK.packed_conv_plain(fop, [fx]))
    del fop, fx
    dop, _ = flagship_dense(dev)
    c = dop.cfg
    dx = rand(rng, (c.bs, c.ih, c.iw, c.ic), u8, dev)
    par.check("conv_fused", "bench.py --dense 8x126x126x256 fused",
              K.conv_cuda(dop, dx), K.conv_plain(dop, dx))
    del dop, dx
    pop, pb, _ = flagship_pair(dev)
    px = packed_input(rng, pop.sin, pb, dev)
    par.check("pair_conv", "bench.py --pair 8x126x126x256 fused x2",
              M.pair_conv_cuda(pop, px), M.pair_conv_plain(pop, px))
    print("parity: FusionNet res merge_pool at batch 8 and 256; K9 against "
          "K1 then K3 at its four layers; VGGFusion's three pairs against "
          "their packed kernels; bench.py's default, --dense and --pair "
          "shapes: bitwise equal", flush=True)


def scaling_layer(dev):
    """bench.py's scaling-op layer (bench.py:730-742): batch 8, 128x128x256
    -> 3x3:256 -> 1x1:256, u8 out, seed 0. Returns (cfg, weights, the input
    on dev)."""
    from deepfusion_tpu_torch.config import ConvConfig
    rng = np.random.default_rng(0)
    bs, hw, c = 8, 128, 256
    src = rng.integers(0, 256, (bs, hw, hw, c), dtype=np.uint8)
    wei = rng.integers(-127, 128, (c, c, 3, 3)).astype(np.int8)
    bia = rng.integers(-100, 101, (c,)).astype(np.int32)
    wei1 = rng.integers(-127, 128, (c, c, 1, 1)).astype(np.int8)
    bia1 = rng.integers(-100, 101, (c,)).astype(np.int32)
    cfg = ConvConfig.make((bs, hw, hw, c), (c, c, 3, 3), bia.dtype, (1, 1),
                          (1, 1), (bs, hw, hw, c), "u8", conv0_scales=(0.001,),
                          wei1x1_shape=(c, c, 1, 1), bia1x1_dt=bia1.dtype,
                          conv1_relu=True, conv1_scales=(0.05,))
    return cfg, (wei, bia, wei1, bia1), torch.from_numpy(src).to(dev)


def vgg_pair(vnet, b, dev, halo=4):
    """VGGFusion block b's pair (its weights, pool2, halo_out 2) on an input
    of halo `halo`: halo_out + ph_a + ph_b = 4 is what sp_packed needs."""
    from deepfusion_tpu_torch.ops.mega import PackedConvPairOp
    from deepfusion_tpu_torch.ops.packed import PackedSpec
    from deepfusion_tpu_torch.utils.mathutil import round_up
    ca, cb = (vnet._conv_cfg(f"block{b}_conv{i}") for i in (1, 2))
    p1, p2 = (vnet.params[f"block{b}_conv{i}"] for i in (1, 2))
    sin = PackedSpec.make(ca.ih, ca.iw, ca.ic, halo=halo, col_off=2,
                          iwp=round_up(ca.iw + 4, 16))
    return PackedConvPairOp(ca, (p1["wei"], p1.get("bia")), cb,
                            (p2["wei"], p2.get("bia")), sin=sin, halo_out=2,
                            col_off_out=2, pool2=True, device=dev)


def acc1_parity(net, dev, par):
    """K1b's and K5's raw 1x1 accumulator (emit_acc1) against their plain
    versions: FusionNet's fused layers, the fused extra cases, junk pads
    for K5 (the tensor-parallel shards are held in ``sharded_parity``)."""
    from deepfusion_tpu_torch.ops import packed as PK
    from deepfusion_tpu_torch.ops.conv import conv_cuda, conv_plain
    from deepfusion_tpu_torch.types import dtype
    rng = np.random.default_rng(17)
    cases = [(f"FusionNet {k}", getattr(net, k)) for k in ("block1", "block2")]
    cases += [(label, op, x) for label, op, x, sm in conv_cases(dev)
              if op.cfg.fuse_conv1x1 and sm is None]
    for case in cases:
        label, op = case[:2]
        c = op.cfg
        x = case[2] if len(case) > 2 else rand(
            rng, (c.bs, c.ih, c.iw, c.ic), dtype.u8, dev)
        par.check("conv_fused", f"acc1 {label}",
                  conv_cuda(op, x, emit_acc1=True),
                  conv_plain(op, x, emit_acc1=True))
    pcases = [(f"FusionNet {k}", op, net.cfg.batch, junk)
              for k, op in net.build_packed().items()
              if op.cfg.fuse_conv1x1 and len(op.sins) == 1
              for junk in (False, True)]
    pcases += [(label, op, n, junk)
               for label, op, n, junk in packed_conv_cases(dev)
               if op.cfg.fuse_conv1x1 and len(op.sins) == 1
               and op.ssum is None and not op.pool2]
    for label, op, n, junk in pcases:
        x = packed_input(rng, op.sin, n, dev, junk)
        par.check("packed_conv", f"acc1 {label} junk={junk}",
                  PK.packed_conv_cuda(op, [x], emit_acc1=True),
                  PK.packed_conv_plain(op, [x], emit_acc1=True))


def range_cuts(rows):
    """Cuts of an array's rows into four ranges: an edge row, a short one,
    the middle, the last rows."""
    return sorted({0, 1, min(3, rows - 1), max(rows - 3, 1), rows})


def range_parity(vnet, dev, par):
    """K5's output row ranges, each from the input row slice it reads (as
    sp_packed calls it), and K10's widened intermediate bounds with row
    ranges, against their plain versions, junk pads included, at every
    range cut of a shard: the pool2 and sum cases and shards of VGGFusion's
    block pairs (the shards phase 6 runs are held in ``sharded_parity``)."""
    from deepfusion_tpu_torch.ops import mega as M
    from deepfusion_tpu_torch.ops import packed as PK
    rng = np.random.default_rng(18)
    ops = [(label, op, n, junk)
           for label, op, n, junk in packed_conv_cases(dev)
           if label.startswith(("pool2", "sum halo+1", "3x3", "fused n",
                                "tile edges", "5x5 pool2"))]
    for label, op, n, junk in ops:
        arrs = [packed_input(rng, s, n, dev, junk) for s in op.sins]
        sm = None if op.ssum is None else packed_input(rng, op.ssum, n, dev,
                                                       junk)
        iwp, c = op.sin.iwp, op.cfg
        rows = op.sout_final.rows
        cuts = range_cuts(rows)
        # and ranges that start inside the kernel's first row tile
        extra = [(5, rows - 1), (7, rows)] if rows > 9 else []
        for r in list(zip(cuts, cuts[1:])) + extra:
            _, _, oy0, oy1 = op._row_plan(r)
            lo = op.sin.halo + oy0 - c.ph
            hi = lo + oy1 - oy0 + c.kh - 1 if oy1 > oy0 else lo
            sl = [a[:, lo * iwp:hi * iwp] for a in arrs]
            kw = dict(rows=r, row0_off=lo)
            par.check("packed_conv", f"rows {r} {label}",
                      PK.packed_conv_cuda(op, sl, sm, **kw),
                      PK.packed_conv_plain(op, sl, sm, **kw))
    for b, sp in ((1, 4), (2, 2), (3, 1)):
        pair = vgg_pair(vnet, b, dev)
        h = pair.cfg_a.ih // sp
        local = pair.reheight(h)
        ph_b = local.cfg_b.ph
        for junk in (False, True):
            x = packed_input(rng, local.sin, vnet.cfg.batch, dev, junk)
            for j, bounds in (("first", (0, h + ph_b)),
                              ("inner", (-ph_b, h + ph_b)),
                              ("last", (-ph_b, h))):
                what = f"VGGFusion block{b} sp={sp} {j} shard junk={junk}"
                par.check("pair_conv", f"bounds {what}",
                          M.pair_conv_cuda(local, x, mid_bounds=bounds),
                          M.pair_conv_plain(local, x, mid_bounds=bounds))
                cuts = range_cuts(local.sout_final.rows)
                iwp, ca = local.sin.iwp, local.cfg_a
                for r in zip(cuts, cuts[1:]):
                    y0, y1 = local._mid_rows(r, bounds)
                    lo = local.sin.halo + y0 - ca.ph
                    hi = lo + y1 - y0 + ca.kh - 1 if y1 > y0 else lo
                    kw = dict(rows=r, row0_off=lo, mid_bounds=bounds)
                    xs = x[:, lo * iwp:hi * iwp]
                    par.check("pair_conv", f"rows {r} {what}",
                              M.pair_conv_cuda(local, xs, **kw),
                              M.pair_conv_plain(local, xs, **kw))


def sharded_cases(vnet, dev):
    """Phase 6's cases, built once; phase 3 runs them too. Each is (label,
    sharded call, its input, the single-device call it must equal), on
    meshes whose slots are all this card; the last is three_stage_plan at
    mesh (2, 2, 2) against the same plan at mesh (1, 1, 1)."""
    from deepfusion_tpu_torch.ops.conv import ConvOp
    from deepfusion_tpu_torch.ops.packed import (PackedConvOp, pack_image,
                                                 pack_image_sharded,
                                                 unpack_image,
                                                 unpack_image_sharded)
    from deepfusion_tpu_torch.parallel import (dp_shard, make_mesh,
                                               sp_conv, sp_packed,
                                               tp_fused_conv,
                                               tp_packed_fused)
    from deepfusion_tpu_torch.parallel.plan import three_stage_plan
    from deepfusion_tpu_torch.types import dtype

    def mesh(dp=1, sp=1, tp=1):
        return make_mesh(dp, sp, tp, devices=[dev] * (dp * sp * tp))

    cfg, w, x = scaling_layer(dev)
    op = ConvOp(cfg, *w, device=dev)
    pop = PackedConvOp(cfg, *w, device=dev)
    px = pack_image(x, pop.sin)
    cases = []
    for n in (2, 4):
        for wire in ("psum", "reduce_scatter"):
            cases.append((f"tp_fused_conv tp={n} {wire}",
                          tp_fused_conv(cfg, *w, mesh(tp=n), wire=wire), x,
                          lambda: op(x)))
            cases.append((f"tp_packed_fused tp={n} {wire}",
                          tp_packed_fused(pop, mesh(tp=n), wire=wire), px,
                          lambda: pop(px)))
    for label, m, dp_axis in (("sp=2", mesh(sp=2), None),
                              ("sp=4", mesh(sp=4), None),
                              ("dp=2 x sp=2", mesh(dp=2, sp=2), "dp")):
        cases.append((f"sp_conv {label}", sp_conv(op, m, dp_axis=dp_axis), x,
                      lambda: op(x)))

    def sp_case(label, pk, n, img):
        fn = sp_packed(pk, mesh(sp=n))
        xs = pack_image_sharded(img, fn.local_spec, n)
        g = pk.pack_input(img)
        cases.append((label, lambda a: unpack_image_sharded(
            fn(a), fn.local_out_spec, n), xs,
            lambda: unpack_image(pk(g), pk.sout_final)))
    for n in (2, 4):
        sp_case(f"sp_packed packed conv sp={n}", pop, n, x)
    pair1 = vnet.build_packed()[0]
    cp = vnet.convpool2[0]
    u8 = rand(np.random.default_rng(19),
              (vnet.cfg.batch, cp.cfg.ih, cp.cfg.iw, cp.cfg.ic), dtype.u8, dev)
    p1x = pair1.pack_input(torch.from_numpy(vnet.example_input()).to(dev))
    for label, o, a in (("ConvOp", op, x), ("ConvPoolOp", cp, u8),
                        ("PackedConvOp", pop, px),
                        ("PackedConvPairOp", pair1, p1x)):
        cases.append((f"dp_shard {label} dp=2", dp_shard(o, mesh(dp=2)), a,
                      lambda o=o, a=a: o(a)))
    rng = np.random.default_rng(20)
    for b, n in ((1, 2), (1, 4), (2, 2)):
        pr = vgg_pair(vnet, b, dev)
        img = torch.from_numpy(rng.integers(
            0, 256, (vnet.cfg.batch, pr.sin.h, pr.sin.w, pr.sin.c),
            dtype=np.uint8)).to(dev)
        sp_case(f"sp_packed VGGFusion block{b} pair pool2 sp={n}", pr, n, img)
    # the composed plan at bench.py's scaling-plan widths, hw 128
    mb, hw, c = PLAN["mb"], PLAN["hw"], PLAN["c"]
    steps = {m: three_stage_plan(mesh(*m), mb, hw, c, c, c,
                                 rng=np.random.default_rng(0))[0]
             for m in ((2, 2, 2), (1, 1, 1))}
    src = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (mb, hw, hw, c), dtype=np.uint8)).to(dev)
    cases.append((f"three_stage_plan {(mb, hw, hw, c)} mesh (2, 2, 2) "
                  "against mesh (1, 1, 1)", steps[(2, 2, 2)], src,
                  lambda: steps[(1, 1, 1)](src)))
    return cases


def sharded_parity(cases, par):
    """Phase 3's hold of the sharded path's kernel modes at phase 6's
    shapes: each case's sharded call and its single-device call once, every
    kernel launch inside them against its plain version."""
    for label, fn, a, single in cases:
        with held_against_plain(par, label):
            fn(a)
            single()


def phase_sharded(cases, name_power):
    """Phase 6: the sharded calls alone, with the launch counts set to 0
    before and read after, every kernel and mode of the path launched;
    then each result against its single-device call, bitwise; then each
    sharded call's time against the single-device call's. Returns the
    sharded calls' launch counts."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.utils.logger import check
    _build.reset_launch_counts()
    with torch.inference_mode():
        got = [fn(a) for _, fn, a, _ in cases]
        torch.cuda.synchronize()
    counts, modes = _build.launch_counts(), _build.mode_counts()
    print(f"sharded: launches of the sharded calls {counts}; modes {modes}",
          flush=True)
    for k in _build.MODES:
        check((modes[k] > 0) == (k in SHARDED_MODES),
              f"kernel mode {k}: launched {modes[k]} times on the sharded "
              "path")
    for k in ("conv_fused", "packed_conv", "pair_conv", "convpool"):
        check(counts[k] > 0, f"kernel {k} was not launched on the sharded "
                             "path")
    with torch.inference_mode():
        for (label, _, _, single), g in zip(cases, got):
            want = single()
            torch.cuda.synchronize()
            check(g.device == want.device and torch.equal(g, want),
                  f"{label}: not bitwise equal to the single-device call")
            print(f"sharded: {label}: {tuple(g.shape)} bitwise equal to the "
                  "single-device call", flush=True)
    del got
    with torch.inference_mode():
        for label, fn, a, single in cases:
            t_s, t_1 = cuda_ms(lambda: fn(a), reps=5), cuda_ms(single, reps=5)
            print(f"timing: sharded {label} ms={t_s:.4f} single_device_ms="
                  f"{t_1:.4f} ratio={t_s / t_1:.3f} (one card, shards in "
                  f"turn) card=\"{name_power}\"", flush=True)
    return counts


# ------------------------------------------------------- 6b: across processes

PROCESS_WORLD = 2
PROCESS_TIMEOUT_S = 600       # each worker's own limit
PROCESS_KERNELS = ("conv_fused", "packed_conv", "pair_conv", "convpool")


def block_of(full, meta):
    """The block (r0, r1, n_dp, c0, c1, n_sp) of a whole array: batch rows
    [r0, r1) of n_dp equal parts by dim-1 rows [c0, c1) of n_sp."""
    r0, r1, n_dp, c0, c1, n_sp = meta
    b, d = full.shape[0] // n_dp, full.shape[1] // n_sp
    return full[r0 * b:r1 * b, c0 * d:c1 * d]


def process_collectives(dev):
    """Each collective of parallel/shard.py on int32 and uint8 parts on the
    card, between this rank's slot and the other's, against the same
    collective over both parts in this process (a mesh of two slots on
    this card)."""
    from deepfusion_tpu_torch.parallel import make_mesh
    from deepfusion_tpu_torch.parallel.shard import (all_gather, ppermute,
                                                     psum, psum_scatter)
    from deepfusion_tpu_torch.utils.logger import check
    n = PROCESS_WORLD
    line = make_mesh(tp=n).line("tp")
    local = make_mesh(tp=n, devices=[dev] * n).line("tp")
    rng = np.random.default_rng(30)
    for dt in (torch.int32, torch.uint8):
        parts = [rand(rng, (2, 3, 4, 8), dtype_of(dt), dev).permute(
            3, 2, 1, 0) for _ in range(n)]
        mine = [parts[i] for i in line.mine]

        def run(ps, ln):
            return {"psum": psum(ps, ln), "psum_scatter": psum_scatter(
                ps, ln, 3), "all_gather": all_gather(ps, ln, 3),
                "ppermute": ppermute(ps, ln, [(i, (i + 1) % n)
                                              for i in range(n)])()}
        got, want = run(mine, line), run(parts, local)
        for k, outs in got.items():
            for i, g in zip(line.mine, outs):
                check(g.device == dev and torch.equal(g, want[k][i]),
                      f"{k} of {dt} across processes differs from one "
                      "process's")
    print(f"processes: psum, psum_scatter, all_gather, ppermute of int32 "
          f"and uint8 on {dev} across the ranks equal one process's",
          flush=True)


def dtype_of(dt):
    from deepfusion_tpu_torch.types import dtype
    return dtype.s32 if dt == torch.int32 else dtype.u8


def process_cases(dev, vnet):
    """Phase 6b's cases on meshes that span the ranks: (label, sharded call,
    its global inputs, this rank's block of them, the single-device call
    of the whole, how to read a part back as the dense result, the mesh).
    One slot per rank, except three_stage_plan (two slots per rank, both
    this card)."""
    from deepfusion_tpu_torch.models import FusionNet, FusionNetConfig
    from deepfusion_tpu_torch.ops.conv import ConvOp
    from deepfusion_tpu_torch.ops.packed import (PackedConvOp, pack_image,
                                                 pack_image_sharded,
                                                 unpack_image,
                                                 unpack_image_sharded)
    from deepfusion_tpu_torch.parallel import (dp_shard, make_mesh, sp_conv,
                                               sp_packed, tp_fused_conv,
                                               tp_packed_fused)
    from deepfusion_tpu_torch.parallel.plan import three_stage_plan
    from deepfusion_tpu_torch.types import dtype
    n = PROCESS_WORLD
    whole = (0, 1, 1, 0, 1, 1)
    cases = []

    def dp_case(label, op, x):
        mesh = make_mesh(dp=n)
        line = mesh.line("dp", **mesh.home("dp"))
        cases.append((label, dp_shard(op, mesh), [x],
                      (line.mine[0], line.mine[-1] + 1, n, 0, 1, 1),
                      lambda: op(x), None, mesh))

    def sp_block(fn, mesh):
        (r0, r1), (c0, c1) = fn.block
        return (r0, r1, mesh.shape["dp"], c0, c1, mesh.shape["sp"])

    net = FusionNet(FusionNetConfig(), device=dev)
    x16 = torch.from_numpy(np.concatenate([net.example_input(
        np.random.default_rng(s)) for s in (0, 1)])).to(dev)
    dp_case("dp_shard FusionNet dp=2, global batch 16", net, x16)
    cp = vnet.convpool2[0]
    u8 = rand(np.random.default_rng(19),
              (vnet.cfg.batch, cp.cfg.ih, cp.cfg.iw, cp.cfg.ic), dtype.u8, dev)
    dp_case("dp_shard ConvPoolOp dp=2", cp, u8)
    cfg, w, x = scaling_layer(dev)
    op = ConvOp(cfg, *w, device=dev)
    pop = PackedConvOp(cfg, *w, device=dev)
    px = pack_image(x, pop.sin)
    mesh = make_mesh(sp=n)
    fn = sp_conv(op, mesh)
    cases.append((f"sp_conv sp={n}", fn, [x], sp_block(fn, mesh),
                  lambda: op(x), None, mesh))
    for wire in ("psum", "reduce_scatter"):
        mesh = make_mesh(tp=n)
        cases.append((f"tp_fused_conv tp={n} {wire}",
                      tp_fused_conv(cfg, *w, mesh, wire=wire), [x], whole,
                      lambda: op(x), None, mesh))
        mesh = make_mesh(tp=n)
        cases.append((f"tp_packed_fused tp={n} {wire}",
                      tp_packed_fused(pop, mesh, wire=wire), [px], whole,
                      lambda: pop(px), None, mesh))

    def sp_case(label, pk, img):
        mesh = make_mesh(sp=n)
        fn = sp_packed(pk, mesh)
        meta = sp_block(fn, mesh)
        g = pk.pack_input(img)
        cases.append((label, fn, [pack_image_sharded(img, fn.local_spec, n)],
                      meta, lambda: unpack_image(pk(g), pk.sout_final),
                      lambda a: unpack_image_sharded(
                          a, fn.local_out_spec, meta[4] - meta[3]), mesh))
    sp_case(f"sp_packed packed conv sp={n}", pop, x)
    rng = np.random.default_rng(20)
    for b in (1, 2):
        pr = vgg_pair(vnet, b, dev)
        img = torch.from_numpy(rng.integers(
            0, 256, (vnet.cfg.batch, pr.sin.h, pr.sin.w, pr.sin.c),
            dtype=np.uint8)).to(dev)
        sp_case(f"sp_packed VGGFusion block{b} pair pool2 sp={n}", pr, img)
    mb, hw, c = PLAN["mb"], PLAN["hw"], PLAN["c"]
    mesh = make_mesh(1, n, 2, local_devices=[dev, dev])
    step = three_stage_plan(mesh, mb, hw, c, c, c,
                            rng=np.random.default_rng(0))[0]
    single = three_stage_plan(make_mesh(devices=[dev]), mb, hw, c, c, c,
                              rng=np.random.default_rng(0))[0]
    src = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (mb, hw, hw, c), dtype=np.uint8)).to(dev)
    (r0, r1), (c0, c1) = step.block
    cases.append((f"three_stage_plan {(mb, hw, hw, c)} mesh (1, {n}, 2), "
                  "two slots per rank", step, [src],
                  (r0, r1, 1, c0, c1, n), lambda: single(src), None, mesh))
    return cases


def process_worker(rank: int, world: int, port: int, backend: str):
    """One rank of phase 6b: join the group, check the collectives, run the
    sharded calls on its block of each input between setting the launch
    counts to 0 and reading them, then hold each output against its block
    of the single-device call on this card, then time both. Prints
    ``PROCESSES_OK <rank> <launch counts>`` last."""
    import torch.distributed as dist

    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.models import VGGFusion, VGGFusionConfig
    from deepfusion_tpu_torch.parallel import distributed
    from deepfusion_tpu_torch.utils.logger import check
    distributed.initialize(f"localhost:{port}", world, rank, backend=backend,
                           timeout_s=PROCESS_TIMEOUT_S)
    dev = distributed.local_devices()[1][0]
    torch.cuda.set_device(dev)
    name_power = card()
    print(f"rank {rank} of {world} over {dist.get_backend()} on {dev} "
          f"({torch.cuda.get_device_name(dev)})", flush=True)
    process_collectives(dev)
    vnet = VGGFusion(VGGFusionConfig(), device=dev)
    vnet.build_packed()
    cases = process_cases(dev, vnet)
    _build.reset_launch_counts()
    got, wire = [], []
    with torch.inference_mode():
        for label, fn, xs, meta, _, _, mesh in cases:
            mesh.wire_bytes = 0
            got.append(fn(*[block_of(a, meta) for a in xs]))
            wire.append(mesh.wire_bytes)
        torch.cuda.synchronize()
    counts, modes = _build.launch_counts(), _build.mode_counts()
    print(f"launches of the sharded calls {counts}; modes {modes}",
          flush=True)
    for k in PROCESS_KERNELS:
        check(counts[k] > 0, f"kernel {k} was not launched on rank {rank}")
    with torch.inference_mode():
        for (label, fn, xs, meta, single, dense, _), g, b in zip(
                cases, got, wire):
            want = block_of(single(), meta)
            g = g if dense is None else dense(g)
            torch.cuda.synchronize()
            check(g.device == dev and torch.equal(g, want),
                  f"{label}: rank {rank}'s part differs from its block of "
                  "the single-device call")
            print(f"{label}: part {tuple(g.shape)} (block {meta}) bitwise "
                  f"equal to the single-device call's; wire bytes {b}",
                  flush=True)
    del got
    with torch.inference_mode():
        for label, fn, xs, meta, single, _, _ in cases:
            part = [block_of(a, meta) for a in xs]
            t_s = cuda_ms(lambda: fn(*part), reps=3, warmup=1)
            t_1 = cuda_ms(single, reps=3, warmup=1)
            print(f"timing: processes {label} rank={rank} ms={t_s:.4f} "
                  f"single_device_ms={t_1:.4f} wire={dist.get_backend()} "
                  f"card=\"{name_power}\"", flush=True)
    dist.destroy_process_group()
    print(f"PROCESSES_OK {rank} {json.dumps(counts)}", flush=True)


def phase_processes(name_power, backend=None) -> dict:
    """Phase 6b: two worker processes of this script (``--worker RANK WORLD
    PORT BACKEND``), each with its own time limit, rank r on cuda:(r modulo
    the cards), over ``backend``: by default NCCL where there is a card per
    rank, else gloo (both ranks on cuda:0). A worker that fails, outlives
    its limit or prints no OK line fails the phase. Returns the ranks'
    launch counts, summed."""
    import tempfile

    from deepfusion_tpu_torch.utils.logger import check
    world, cards = PROCESS_WORLD, torch.cuda.device_count()
    backend = backend or ("nccl" if cards >= world else "gloo")
    print(f"processes: {world} ranks over {backend} on "
          f"{[f'cuda:{r % cards}' for r in range(world)]}"
          + (": the bytes cross through host memory" if backend == "gloo"
             else "")
          + ("; the ranks share a card: the times are not a multi-card "
             "run's" if cards < world else "")
          + f" card=\"{name_power}\"", flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    logs = [tempfile.TemporaryFile("w+") for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(world), str(port), backend], stdout=logs[r],
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    # a rank that fails leaves the other waiting in a collective: stop it
    deadline = time.monotonic() + PROCESS_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs) and not any(
                p.poll() for p in procs) and time.monotonic() < deadline:
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    counts = dict.fromkeys(KERNEL_INFO, 0)
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        lines = log.read().splitlines()
        log.close()
        for line in lines:
            print(f"processes: rank {r}: {line}", flush=True)
        check(p.returncode == 0,
              f"phase 6b: rank {r} exited with {p.returncode}")
        ok = [ln for ln in lines if ln.startswith(f"PROCESSES_OK {r} ")]
        check(bool(ok), f"phase 6b: rank {r} printed no OK line")
        got = json.loads(ok[-1].split(" ", 2)[2])
        for k in counts:
            counts[k] += got[k]
    print(f"processes: launches of both ranks' sharded calls {counts}",
          flush=True)
    return counts


def slice_requests(net, golden_path):
    """20 requests (the golden input's 8 first, where stored), the plain
    dense forward's logits for them on the CPU (the same model, built on
    the CPU), and the golden logits."""
    from deepfusion_tpu_torch.utils.logger import check_eq
    cfg = net.cfg
    reqs = []
    golden = None
    if golden_path is not None and os.path.exists(golden_path):
        golden = np.load(golden_path)
        check_eq(int(golden["model_seed"]), cfg.seed, "golden model seed")
        reqs += list(net.example_input(
            np.random.default_rng(int(golden["input_seed"]))))
    rng = np.random.default_rng(123)
    while len(reqs) < 20:
        reqs.append(rng.integers(0, 256, net.input_shape[1:], dtype=np.uint8))
    with torch.inference_mode():
        want = type(net)(cfg, device="cpu")(np.stack(reqs)).numpy()
    return reqs, want, golden


def phase_slice(model, cfg, path, kernels, reqs, want, golden,
                batch=None, tag="slice") -> dict:
    """Serve reqs through `model` behind BatchServer at `batch` (default
    the model's); every kernel of the path must launch in this run, every
    answer must be bitwise right, and each forward must launch what
    FORWARD_LAUNCHES says (where it names the path). `path` names the
    model and the forward, `tag` the phase that prints."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.serving import BatchServer
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    _build.reset_launch_counts()
    srv = BatchServer(model, batch=batch or cfg.batch,
                      input_shape=reqs[0].shape)
    with srv:
        outs = [f.result(timeout=300) for f in srv.submit_many(reqs)]
    counts, modes = _build.launch_counts(), _build.mode_counts()
    print(f"{tag}: {path} path: {len(reqs)} requests served in "
          f"{srv.stats['flushes']} flushes ({srv.stats['padded_rows']} "
          f"padded rows); launches {counts}", flush=True)
    check_eq(srv.stats["requests"], len(reqs), "served requests")
    for k in kernels:
        check(counts[k] > 0,
              f"kernel {k} was not launched on the {path} path")
    per_forward = FORWARD_LAUNCHES.get(path)
    if per_forward is not None:
        flushes = srv.stats["flushes"]
        got = {k: v / flushes for k, v in counts.items() if v}
        check_eq(got, per_forward, f"{path}: launches per forward")
        print(f"{tag}: {path} path: launches per forward {per_forward}, "
              f"as before", flush=True)
    for mode, (per_path, what) in FORWARD_MODES.items():
        want_mode = per_path.get(path, 0)
        check_eq(modes[mode], want_mode * srv.stats["flushes"],
                 f"{path}: K1 launches that {what} ({mode})")
        print(f"{tag}: {path} path: {want_mode} K1 launches a forward "
              f"{what} ({mode})", flush=True)

    got = np.stack(outs)
    check_eq(got.shape, (len(reqs), cfg.num_classes), "served logits shape")
    check(got.dtype == np.float32 and np.isfinite(got).all(),
          "served logits must be finite f32")
    check(np.array_equal(got, want),
          f"{path} served logits differ from the CPU plain dense forward: "
          f"max_abs_err {np.abs(got - want).max()}")
    msg = "bitwise equal to the CPU plain dense forward"
    if golden is not None:
        check(np.array_equal(got[:cfg.batch], golden["logits"]),
              f"{path} card logits differ from the JAX package's golden "
              f"logits: max_abs_err "
              f"{np.abs(got[:cfg.batch] - golden['logits']).max()}")
        msg += " and to the JAX package's golden logits"
    print(f"{tag}: {path} path: {len(reqs)} served answers {msg}",
          flush=True)
    return counts


def phase_hybrid(vnet, golden_path) -> dict:
    """VGGFusion's hybrid forward (block 1 on the conv pair, the dense tail)
    on the golden batch: its kernels must launch and its logits must equal
    the JAX package's golden logits bitwise."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.utils.logger import check
    golden = np.load(golden_path)
    x = vnet.example_input(np.random.default_rng(int(golden["input_seed"])))
    _build.reset_launch_counts()
    with torch.inference_mode():
        got = vnet.hybrid_call(torch.from_numpy(x).to(vnet.device))
    got = got.cpu().numpy()
    counts = _build.launch_counts()
    print(f"slice: VGGFusion hybrid path: golden batch of {len(x)}; "
          f"launches {counts}", flush=True)
    for k in PATH_KERNELS[("VGGFusion", "hybrid")]:
        check(counts[k] > 0,
              f"kernel {k} was not launched on the VGGFusion hybrid path")
    check(got.dtype == np.float32 and np.isfinite(got).all(),
          "hybrid logits must be finite f32")
    check(np.array_equal(got, golden["logits"]),
          f"VGGFusion hybrid logits differ from the JAX package's golden "
          f"logits: max_abs_err {np.abs(got - golden['logits']).max()}")
    print("slice: VGGFusion hybrid path: logits bitwise equal to the JAX "
          "package's golden logits", flush=True)
    return counts


def phase_dp_served(golden_path) -> dict:
    """FusionNet(FusionNetConfig()), built on the CPU, batch-split by
    dp_shard over a mesh of two slots that are both this card (each slot a
    copy of the model moved to cuda:0, its ops' tensor maps encoded anew),
    served behind BatchServer at twice the model's batch: 16 requests,
    bitwise against the CPU plain dense forward and the golden logits."""
    from deepfusion_tpu_torch.models import FusionNet, FusionNetConfig
    from deepfusion_tpu_torch.parallel import dp_shard, make_mesh
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    cfg = FusionNetConfig()
    cpu_net = FusionNet(cfg, device="cpu")
    fwd = dp_shard(cpu_net, make_mesh(dp=2, devices=["cuda:0", "cuda:0"]))
    check_eq(fwd.device, torch.device("cuda:0"), "dp-split callable device")
    check(cpu_net.device == torch.device("cpu"),
          "dp_shard must copy the model, not move it")
    reqs, want, golden = slice_requests(cpu_net, golden_path)
    return phase_slice(fwd, cfg, "FusionNet dense dp=2 split", PATH_KERNELS[
        ("FusionNet", "dense")], reqs[:16], want[:16], golden,
        batch=2 * cfg.batch)


# the device kernels behind each counted wrapper, by the name torch.profiler
# gives them (K3's three, K6-K8's two)
TRACED = {"conv_fused": "conv_fused", "conv_fused_s8src": "conv_fused",
          "concat_relu": "concat_relu",
          "pool": "pool", "pool_vec": "pool", "pool_split": "pool",
          "sum_relu": "sum_relu", "packed_conv": "packed_conv",
          "packed_sum_pool": "packed_sum_pool",
          "packed_maxpool2": "packed_sum_pool", "convpool": "convpool",
          "pair_conv": "pair_conv", "unfold_cols": "unfold_cols",
          "depthwise": "depthwise"}
TRACED_RE = re.compile(r"(?<![A-Za-z_])(%s)_kernel" % "|".join(TRACED))
TRACE_TRIES = 3


def traced_launches(fn) -> dict:
    """{counted kernel: launches} of the package's device kernels that
    torch.profiler traces in one call of fn(), the call after a warm-up
    call (a trace can miss the device work that starts right after it
    does: a replay's input copy and first kernel, PERF.md §7)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    out = {}
    for e in prof.key_averages():
        m = TRACED_RE.search(e.key)
        if m and e.self_device_time_total > 0:
            k = TRACED[m.group(1)]
            out[k] = out.get(k, 0) + e.count
    return out


def phase_graphs(slices, dev) -> dict:
    """Phase 4b: each model's jit() and jit_packed() (a CUDA graph per
    input shape) at full width, batch 8. Per callable: the first call
    captures; one replay launches what FORWARD_LAUNCHES says, by the
    counters and by torch.profiler's trace; 20 requests behind
    BatchServer, bitwise against the CPU plain dense forward and the
    golden logits; a first result unchanged by a later call; batch 3
    captures a second graph and answers right. A model without
    jit_packed() runs jit() alone. Last, the last model's graph must
    refuse to replay once its weights moved. `slices` is [(model, reqs,
    want, golden)]. Returns the launch counts of the served runs."""
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.utils.logger import CheckError, check, check_eq
    counts = dict.fromkeys(KERNEL_INFO, 0)
    for model, reqs, want, golden in slices:
        name, n = type(model).__name__, model.cfg.batch
        paths = [("dense", "jit")]
        if hasattr(model, "jit_packed"):
            paths.append(("packed", "jit_packed"))
        for path, method in paths:
            label = f"{name} {path}"
            g = getattr(model, method)()
            check_eq(g.device, dev, f"{label} {method}() device")
            check_eq(g.input_shape, model.input_shape,
                     f"{label} {method}() input_shape")
            x = torch.from_numpy(np.stack(reqs[:n])).to(dev)
            x2 = torch.from_numpy(np.stack(reqs[n:2 * n])).to(dev)
            first = g(x)
            check_eq(g.captures, 1, f"{label}: graphs after the first call")
            kept = first.clone()
            want_l = FORWARD_LAUNCHES[label]
            _build.reset_launch_counts()
            g(x)
            by_count = {k: v for k, v in _build.launch_counts().items() if v}
            check_eq(by_count, want_l,
                     f"{label} {method}(): counted launches per replay")
            # a profile may drop a kernel's record (PERF.md §7), never add
            # one: up to TRACE_TRIES profiles, none tracing more than the
            # forward's launches, one tracing all of them
            for tries in range(1, TRACE_TRIES + 1):
                traced = traced_launches(lambda: g(x))
                check(all(v <= want_l.get(k, 0) for k, v in traced.items()),
                      f"{label} {method}(): one replay traced {traced}, more "
                      f"than {want_l}")
                if traced == want_l:
                    break
                print(f"graphs: {label} {method}(): profile {tries} traced "
                      f"{traced}, fewer than {want_l}", flush=True)
            check_eq(traced, want_l,
                     f"{label} {method}(): traced launches per replay in "
                     f"{TRACE_TRIES} profiles")
            print(f"graphs: {label} {method}(): one replay launched "
                  f"{traced} (torch.profiler, profile {tries}) and counted "
                  f"{by_count}, as FORWARD_LAUNCHES says", flush=True)
            second = g(x2)
            torch.cuda.synchronize()
            check(torch.equal(first, kept), f"{label}: a later call changed "
                                            "a returned result")
            check(np.array_equal(first.cpu().numpy(), want[:n])
                  and np.array_equal(second.cpu().numpy(), want[n:2 * n]),
                  f"{label} {method}(): logits differ from the CPU plain "
                  "dense forward")
            small = g(x[:3])
            check_eq(g.captures, 2, f"{label}: graphs after a batch of 3")
            check(np.array_equal(small.cpu().numpy(), want[:3]),
                  f"{label} {method}(): batch 3 differs from the CPU plain "
                  "dense forward")
            print(f"graphs: {label} {method}(): a first result unchanged by "
                  "a second call; batch 3 captured a second graph; all "
                  "bitwise equal to the CPU plain dense forward", flush=True)
            got = phase_slice(g, model.cfg, label, PATH_KERNELS[(name, path)],
                              reqs, want, golden, tag="graphs")
            for k in KERNEL_INFO:
                counts[k] += got[k]
            del g, first, kept, second, small
    # a graph bakes in the weights' addresses: once they move, it raises
    model, reqs, want, _ = slices[-1]
    x = torch.from_numpy(np.stack(reqs[:model.cfg.batch])).to(dev)
    g = model.jit()
    g(x)

    def refused(moved):
        try:
            g(x)
        except CheckError as e:
            print(f"graphs: {type(model).__name__} jit() refused a call "
                  f"after the model moved {moved}: {e}", flush=True)
        else:
            raise RuntimeError(f"a graph ran after its model moved {moved}")

    model.to("cpu")
    refused("to the CPU")
    model.to(dev)
    refused("to the CPU and back")
    check(np.array_equal(model.jit()(x).cpu().numpy(),
                         want[:model.cfg.batch]),
          "jit() after the move differs from the CPU plain dense forward")
    return counts


def phase_object_api(dev, name_power) -> dict:
    """Phase 7: one chain of object-API submits on cuda:0 from host-filled
    memory (concat -> fused conv -> max pool -> eltwise sum) at FusionNet's
    widths: each result a CUDA tensor, every kernel of the chain launched,
    the result bitwise the functional ops' on the CPU; with
    DEEPFUSION_PROFILE=1 the submits' log lines; then each submit's host
    time against its functional call's, in turns; the device's
    capabilities and the single-process distributed init."""
    import logging

    import deepfusion_tpu_torch as df
    from deepfusion_tpu_torch import _build
    from deepfusion_tpu_torch.ops.concat import concat
    from deepfusion_tpu_torch.ops.conv import ConvOp
    from deepfusion_tpu_torch.ops.pool import eltwise_sum_relu, pool
    from deepfusion_tpu_torch.parallel import distributed
    from deepfusion_tpu_torch.utils.logger import check, check_eq
    print(f"api: device_capabilities() {df.device_capabilities()}",
          flush=True)
    distributed.initialize()
    check(not torch.distributed.is_initialized(),
          "initialize() of one process must be a no-op")
    print(f"api: distributed.initialize() single-process no-op; "
          f"local_batch_slice(16)={distributed.local_batch_slice(16)} "
          f"global_devices_mesh_shape()="
          f"{distributed.global_devices_mesh_shape()}", flush=True)

    n, hw, w = 8, 56, 64
    rng = np.random.default_rng(21)
    a = df.memory([n, w, hw, hw], df.format.nhwc, df.u8).fill_random(rng)
    b = df.memory([n, w, hw, hw], df.format.nhwc, df.u8).fill_random(rng)
    mid = df.memory([n, 2 * w, hw, hw], df.format.nhwc, df.u8)
    wei = df.memory([2 * w, 2 * w, 3, 3], df.format.OIhw4i16o4i, df.s8)
    wei.data = rng.integers(-128, 128, (2 * w, 2 * w, 3, 3)).astype(np.int8)
    wei1 = df.memory([w, 2 * w, 1, 1], df.format.OIhw4i16o4i, df.s8)
    wei1.data = rng.integers(-128, 128, (w, 2 * w, 1, 1)).astype(np.int8)
    bia = df.memory([2 * w], df.format.x, df.s32)
    bia.data = rng.integers(-5000, 5000, (2 * w,)).astype(np.int32)
    fused = df.memory([n, w, hw, hw], df.format.nhwc, df.u8)
    pooled = df.memory([n, w, hw // 2, hw // 2], df.format.nhwc, df.u8)
    res = df.memory([n, w, hw // 2, hw // 2], df.format.nhwc,
                    df.u8).fill_random(rng)
    out = df.memory([n, w, hw // 2, hw // 2], df.format.nhwc, df.u8)
    host = {k: m.numpy().copy() for k, m in (("a", a), ("b", b),
                                             ("res", res))}
    sc0, sc1 = (1.0 / (9 * 2 * w * 60),), (1.0 / (2 * w * 60),)
    ops = [("concat", df.concat([a, b], mid, post_relu=True)),
           ("conv", df.conv(mid, wei, bia, (1, 1), (1, 1), wei1, None,
                            fused, True, sc0, "nearest", True, sc1)),
           ("pool", df.pool(fused, pooled, "max", (2, 2), (2, 2), (0, 0))),
           ("eltwise", df.eltwise_sum_relu(pooled, res, out))]
    for name, o in ops:
        check_eq(o.device, dev, f"object API {name} op device")
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    keep = Keep()
    log = logging.getLogger("deepfusion_tpu_torch")
    log.addHandler(keep)
    os.environ["DEEPFUSION_PROFILE"] = "1"
    _build.reset_launch_counts()
    try:
        with torch.inference_mode():
            for _, o in ops:
                o.submit()
        torch.cuda.synchronize()
    finally:
        del os.environ["DEEPFUSION_PROFILE"]
        log.removeHandler(keep)
    counts = _build.launch_counts()
    print(f"api: chain concat -> fused conv -> pool -> eltwise sum on "
          f"{dev}: launches {counts}", flush=True)
    for k in ("concat_relu", "conv_fused", "pool", "sum_relu"):
        check(counts[k] > 0, f"the object API chain did not launch {k}")
    for m, what in ((a, "a"), (mid, "mid"), (fused, "fused"),
                    (pooled, "pooled"), (out, "out")):
        check(isinstance(m.data, torch.Tensor) and m.data.device == dev,
              f"object API memory {what} must hold a tensor on {dev}")
    for _, o in ops:
        check(any(f"{o.name()} infer" in r and r.endswith(" ms")
                  for r in records),
              f"no profile line of the {o.name()} submit: {records}")
    for r in records:
        print(f"api: profile log: {r}", flush=True)
    with torch.inference_mode():
        cpu = torch.device("cpu")
        cop = ConvOp(ops[1][1]._impl.cfg, wei.numpy(), bia.numpy(),
                     wei1.numpy(), None, device=cpu)
        m = concat([torch.from_numpy(host["a"]), torch.from_numpy(host["b"])],
                   post_relu=True)
        want = eltwise_sum_relu(pool(cop(m), "max", (2, 2), (2, 2), (0, 0)),
                                torch.from_numpy(host["res"]))
    check(torch.equal(out.data.cpu(), want),
          "object API chain on the card differs from the functional ops "
          "on the CPU")
    print("api: chain result bitwise equal to the functional ops on the CPU",
          flush=True)
    # host time per submit against the functional call on the same tensors
    fns = {"concat": lambda: concat([a.data, b.data], True),
           "conv": lambda: ops[1][1]._impl(mid.data),
           "pool": lambda: pool(fused.data, "max", (2, 2), (2, 2), (0, 0)),
           "eltwise": lambda: eltwise_sum_relu(pooled.data, res.data)}
    with torch.inference_mode():
        for name, o in ops:
            us = {"submit": [], "functional": []}
            calls = 200
            for _ in range(3):
                for k, fn in (("submit", o.submit), ("functional", fns[name]),
                              ("functional", fns[name]), ("submit",
                                                          o.submit)):
                    fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    us[k].append((time.perf_counter() - t0) / calls * 1e6)
                    torch.cuda.synchronize()
            sub, fun = (statistics.median(us[k]) for k in us)
            print(f"api: host {name} submit_us={sub:.3f} "
                  f"functional_us={fun:.3f} overhead_us={sub - fun:.3f} "
                  f"(medians of 6 loops of {calls} in turns; the queue "
                  f"may fill, so a host time above the device time "
                  f"includes the wait) card=\"{name_power}\"", flush=True)
    return counts


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        rank, world, port = (int(a) for a in sys.argv[2:5])
        return process_worker(rank, world, port, sys.argv[5])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA H100", file=sys.stderr)
        sys.exit(1)
    if len(sys.argv) > 1 and sys.argv[1] == "--phase-6b":
        # phases 1, 2 and 6b alone, over the wire named after the flag
        name_power = phase_device()
        phase_build(name_power)
        phase_processes(name_power, *sys.argv[2:3])
        print(name_power)
        return
    from deepfusion_tpu_torch.models import (FusionNetConfig, GoogLeNet,
                                             GoogLeNetConfig, MobileNetV2,
                                             MobileNetV2Config, ResFusionNet,
                                             ResFusionNetConfig, ResNet50,
                                             ResNet50Config, VGGFusion,
                                             VGGFusionConfig)

    from deepfusion_tpu_torch.utils.logger import check_eq
    name_power = phase_device()
    phase_build(name_power)
    dev = torch.device("cuda:0")
    cfg = FusionNetConfig()
    net = phase_default_device(cfg)
    net.build_packed()
    rnet = ResFusionNet(ResFusionNetConfig(), device=dev)
    rnet.build_packed()
    vnet = VGGFusion(VGGFusionConfig(), device=dev)
    vnet.build_packed()
    r50 = ResNet50(ResNet50Config(), device=dev)
    gnet = GoogLeNet(GoogLeNetConfig(), device=dev)
    mcfg = MobileNetV2Config()
    mparams = MobileNetV2.random_params(mcfg)
    mnet = MobileNetV2.from_numpy_params(mcfg, mparams, device=dev)
    mnet.params = mparams      # the reference's weights (mobilenetv2_parity)
    plan_check((net, rnet, vnet, r50))
    sharded = sharded_cases(vnet, dev)
    with torch.inference_mode():
        phase_parity(net, rnet, vnet, r50, gnet, mnet, dev, sharded)
    counts = dict.fromkeys(KERNEL_INFO, 0)
    slices = []
    for model in (net, rnet, vnet, r50, gnet, mnet):
        name = type(model).__name__
        reqs, want, golden = slice_requests(model, GOLDEN.get(name))
        slices.append((model, reqs, want, golden))
        paths = [("dense", model)]
        if hasattr(model, "packed_module"):
            paths.append(("packed", model.packed_module()))
        for path, served in paths:
            got = phase_slice(served, model.cfg, f"{name} {path}",
                              PATH_KERNELS[(name, path)], reqs, want, golden)
            for k in KERNEL_INFO:
                counts[k] += got[k]
    for got in (phase_hybrid(vnet, GOLDEN["VGGFusion"]),
                phase_dp_served(GOLDEN["FusionNet"]),
                phase_graphs(slices, dev)):
        for k in KERNEL_INFO:
            counts[k] += got[k]
    got = phase_sharded(sharded, name_power)
    check_eq({k: v for k, v in got.items() if v}, SHARDED_LAUNCHES,
             "launches of phase 6's sharded calls")
    for got in (got, phase_processes(name_power),
                phase_object_api(dev, name_power)):
        for k in KERNEL_INFO:
            counts[k] += got[k]
    print(name_power)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "launches": counts[k]}
        for k, src in KERNEL_INFO.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
