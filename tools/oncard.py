"""What the on-card scripts share (chip_smoke.py, tools/kernel_times.py,
tools/k1_ablation.py, tools/k5_ablation.py, tools/model_layers.py): the
card's name, the timers, the input makers, the byte and bound arithmetic,
and the one runner of several trees of the repository in turns.

Nothing here imports the package when this module is imported: a helper
imports what it needs when it is called, so the tree whose package is first
on ``sys.path`` is the one measured (``run_trees``).
"""
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")

REPS = 20
H100_INT8_PEAK_TOPS = 1979.0   # dense, NVIDIA data sheet, SXM at 700 W
H100_CORE_TOPS = 67.0          # f32 outside the tensor cores, same sheet
H100_HBM_TBS = 3.35            # HBM3 bytes/s, same sheet
L2_EVICT_BYTES = 128 << 20     # read between cold calls: 2.56x the 50 MB L2
# the reference's three concat shape sets, side: channels of its four
# inputs (bench.py:450-451, from its benchmark/bench_concat.cc:226-242)
CONCAT_SETS = {244: (128, 256, 128, 256), 64: (64, 96, 64, 96),
               9: (16, 64, 16, 64)}


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timers

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


def kernel_profile(fn, reps):
    """{kernel name: self device us} that torch.profiler records over
    reps calls of fn()."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.self_device_time_total > 0}


def device_ms(fn, reps=REPS, profiles=1, tries=3):
    """Device time per call of fn() in ms: the self device time of every
    kernel and copy it ran, summed by torch.profiler over reps calls; the
    median of `profiles` profiles. A profile that recorded no device
    activity is taken again; after `tries` such profiles the time is not
    measured (nan)."""
    fn()
    torch.cuda.synchronize()
    out, empty = [], 0
    while len(out) < profiles:
        us = sum(kernel_profile(fn, reps).values())
        if us > 0:
            out.append(us / reps / 1e3)
            continue
        empty += 1
        if empty == tries:
            return float("nan")
    return statistics.median(out)


_EVICT = []


def l2_evict():
    """Read a buffer of L2_EVICT_BYTES, 2.56x the H100's 50 MB L2: after
    it no line of an earlier call's data is left in the L2."""
    if not _EVICT:
        _EVICT.append(torch.ones(L2_EVICT_BYTES // 4, dtype=torch.int32,
                                 device="cuda"))
    return _EVICT[0].sum()


def cold_device_ms(fn, reps=REPS, profiles=3, tries=3):
    """Device time per call of fn() with cold caches: every call follows
    l2_evict(), and only fn's own kernels count (the names a profile of fn
    alone records; none may share a name with the eviction's). The median
    of `profiles` profiles; after `tries` profiles that lack one of fn's
    kernels the time is not measured (nan)."""
    l2_evict()
    fn()
    torch.cuda.synchronize()
    own = set(kernel_profile(fn, reps))
    out, missed = [], 0
    while own and len(out) < profiles:
        c = kernel_profile(lambda: (l2_evict(), fn()), reps)
        if own <= set(c):
            out.append(sum(c[k] for k in own) / reps / 1e3)
            continue
        missed += 1
        if missed == tries:
            break
    return statistics.median(out) if len(out) == profiles else float("nan")


# ------------------------------------------------------------ input makers

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


def packed_input(rng, spec, n, dev, junk=False):
    """A packed array for spec: random u8 images packed with -128 pads, or
    (junk) random bytes in every slot, pads included."""
    from deepfusion_tpu_torch.ops.packed import pack_image
    from deepfusion_tpu_torch.types import dtype
    if junk:
        return rand(rng, spec.array_shape(n), dtype.s8, dev)
    img = rng.integers(0, 256, (n, spec.h, spec.w, spec.c), dtype=np.uint8)
    img.reshape(-1)[:2] = [0, 255]
    return pack_image(torch.from_numpy(img).to(dev), spec)


def packed_conv_op(rng, hw, cs, oc, k=3, *, dev, oc1=None, bias=True,
                   per_oc=True, rnd="nearest", halo_in=2, halo_out=1,
                   off_in=2, off_out=2, iwp=None, n=2, sum_halo=None,
                   sum_scale=1.0, pool2=False, merge_pool=False, sc=None):
    """A PackedConvOp with random weights from rng: hw a side or (h, w),
    cs the channels of each input, each c or (c, cp); a 1x1 of oc1 lanes
    fused where oc1 is given; a packed u8 sum operand of halo sum_halo
    where that is given."""
    from deepfusion_tpu_torch.config import ConvConfig
    from deepfusion_tpu_torch.ops import layout
    from deepfusion_tpu_torch.ops.packed import PackedConvOp, PackedSpec
    from deepfusion_tpu_torch.utils.mathutil import conv_output_size
    h, w = (hw, hw) if isinstance(hw, int) else hw
    cs = [(c, None) if isinstance(c, int) else c for c in cs]
    ic, p = sum(c for c, _ in cs), k // 2
    oh, ow = (conv_output_size(d, k, 1, p) for d in (h, w))
    wei = rng.integers(-128, 128, (oc, ic, k, k)).astype(np.int8)
    bia = rng.integers(-5000, 5000, (oc,)).astype(np.int32) if bias else None
    sc = sc or 1.0 / (k * k * ic * 60)
    sc0 = (rng.uniform(0.5, 1.5, oc) * sc).astype(np.float32) \
        if per_oc else (sc,)
    kw = {}
    wei1 = bia1 = None
    if oc1 is not None:
        wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
        bia1 = rng.integers(-5000, 5000, (oc1,)).astype(np.int32) \
            if bias else None
        kw = dict(wei1x1_shape=(oc1, oc, 1, 1),
                  bia1x1_dt=None if bia1 is None else np.int32,
                  conv1_relu=True, conv1_round=rnd,
                  conv1_scales=(rng.uniform(0.5, 1.5, oc1) / (oc * 60)
                                ).astype(np.float32) if per_oc
                  else (1.0 / (oc * 60),))
    cfg = ConvConfig.make((n, h, w, ic), (oc, ic, k, k),
                          None if bia is None else bia.dtype, (1, 1), (p, p),
                          (n, oh, ow, oc1 or oc), "u8", conv0_relu=True,
                          conv0_scales=sc0, conv0_round=rnd,
                          sum_dt=None if sum_halo is None else "u8",
                          sum_scale=sum_scale, **kw)
    sins = tuple(PackedSpec.make(h, w, c, cp=cp, halo=halo_in, col_off=off_in,
                                 iwp=iwp) for c, cp in cs)
    ssum = None if sum_halo is None else PackedSpec(
        h=oh, w=ow, c=oc1 or oc, cp=layout.packed_cp(oc1 or oc),
        halo=sum_halo, col_off=off_out, iwp=sins[0].iwp)
    return PackedConvOp(cfg, wei, bia, wei1, bia1, sin=sins,
                        col_off_out=off_out, halo_out=halo_out,
                        sum_spec=ssum, pool2=pool2, merge_pool=merge_pool,
                        device=dev)


# C13 (input counts and lane widths the packed conv takes only joined) at
# FusionNet's batch 8, side 56 and 128 output lanes, where the join's bytes
# weigh against the kernel's: (label, side, each input's c or (c, cp), oc,
# random pad bytes in the parity case, further packed_conv_op arguments)
C13_CONVS = (
    ("C13 56x56 five inputs of 64", 56, [64] * 5, 128, True, {}),
    ("C13 56x56 fused 8 + 120 lanes", 56, [(8, 8), (120, 120)], 128, True,
     {"oc1": 128}),
    ("C13 56x56 six mixed widths", 56, [(8, 8), (8, 8), (16, 16), (32, 32),
                                        (64, 64), (128, 128)], 128, False,
     {}))


def c13_sum_pool_cases():
    """(label, left input specs, right operand spec, batch) of the packed
    sum/pool at input counts and lane widths that the JAX package takes
    (C13), which the kernel takes as they are: more than four inputs,
    lanes no multiple of 16 (of 8, of 4: the kernel's element narrows),
    130 inputs (one launch per group of 128)."""
    from deepfusion_tpu_torch.ops.packed import PackedSpec
    out = []
    for label, hw, cs, rcp in (
            ("C13 five inputs of 32", 28, [32] * 5, None),
            ("C13 narrow 8 + 24", 28, [8, 24], None),
            ("C13 one input of 8 lanes", 28, [8], 8),
            ("C13 six narrow, 64 lanes", 28, [8, 8, 16, 8, 8, 8], 64),
            ("C13 8 + 32, 40 lanes", 28, [8, 32], None),
            ("C13 word lanes 4 + 12", 28, [4, 12], None),
            ("C13 odd lanes 3 + 5", 28, [3, 5], None),
            ("C13 130 inputs of 8", 28, [8] * 130, None),
            # FusionNet's batch, side and residual width (256 lanes)
            ("C13 56x56 five inputs, 256 lanes", 56, [64, 64, 64, 32, 32],
             None),
            ("C13 56x56 six mixed, 256 lanes", 56, [8, 8, 16, 32, 64, 128],
             None),
            ("C13 56x56 narrow 8 + 120", 56, [8, 120], None)):
        rcp = rcp or sum(cs)
        cps = cs[:-1] + [rcp - sum(cs[:-1])]
        iwp = 32 if hw == 28 else None  # None: PackedSpec's own pitch
        ys = [PackedSpec.make(hw, hw, c, cp=cp, halo=2, col_off=2, iwp=iwp)
              for c, cp in zip(cs, cps)]
        out.append((label, ys, PackedSpec.make(hw, hw, sum(cs), cp=rcp,
                                               halo=2, col_off=2, iwp=iwp),
                    8))
    return out


def flagship_layer(rng):
    """bench.py's default layer (bench.py:275-278): 8x126x126x256 -> 3x3:256
    -> 1x1:256, random weights from rng; returns (cfg, weights, MACs)."""
    from deepfusion_tpu_torch.config import ConvConfig
    n, hw, ic, oc, oc1 = 8, 126, 256, 256, 256
    wei = rng.integers(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
    bia = rng.integers(-5000, 5000, (oc,)).astype(np.int32)
    wei1 = rng.integers(-128, 128, (oc1, oc, 1, 1)).astype(np.int8)
    bia1 = rng.integers(-5000, 5000, (oc1,)).astype(np.int32)
    cfg = ConvConfig.make((n, hw, hw, ic), (oc, ic, 3, 3), np.int32, (1, 1),
                          (1, 1), (n, hw, hw, oc1), "u8", conv0_relu=True,
                          conv0_scales=(1.0 / (9 * ic * 10),),
                          wei1x1_shape=(oc1, oc, 1, 1), bia1x1_dt=np.int32,
                          conv1_relu=True, conv1_scales=(1.0 / (oc * 20),))
    macs = n * hw * hw * (9 * ic * oc + oc * oc1)
    return cfg, (wei, bia, wei1, bia1), macs


def flagship_op(dev):
    """The packed fused conv at bench.py's default shape, PackedConvOp's
    default geometry: (op, batch, MACs)."""
    from deepfusion_tpu_torch.ops.packed import PackedConvOp
    cfg, w, macs = flagship_layer(np.random.default_rng(21))
    return PackedConvOp(cfg, *w, device=dev), cfg.bs, macs


def flagship_dense(dev):
    """K1 at bench.py's --dense shape: bench.py's default layer as a dense
    ConvOp (NHWC u8 in and out): (op, MACs)."""
    from deepfusion_tpu_torch.ops.conv import ConvOp
    cfg, w, macs = flagship_layer(np.random.default_rng(21))
    return ConvOp(cfg, *w, device=dev), macs


def flagship_pair(dev):
    """The conv pair at bench.py's --pair shape (bench.py:257-272): two of
    bench.py's default layers chained, PackedConvPairOp's default geometry
    (halo 1, no pool): (op, batch, MACs)."""
    from deepfusion_tpu_torch.ops.mega import PackedConvPairOp
    rng = np.random.default_rng(22)
    cfg, wa, macs = flagship_layer(rng)
    _, wb, _ = flagship_layer(rng)
    return PackedConvPairOp(cfg, wa, cfg, wb, device=dev), cfg.bs, 2 * macs


# ------------------------------------------------- bytes, operations, bound

def nbytes(*items) -> int:
    """Bytes of the tensors, lists of tensors and modules' operands (their
    persistent buffers: the copies a kernel's layout derives from them hold
    the same weights once more); an int is a byte count already."""
    total = 0
    for it in items:
        if isinstance(it, int):
            total += it
        elif isinstance(it, torch.nn.Module):
            total += sum(b.numel() * b.element_size()
                         for b in it.state_dict().values())
        elif isinstance(it, (list, tuple)):
            total += nbytes(*it)
        elif it is not None:
            total += it.numel() * it.element_size()
    return total


def packed_reads(op, n) -> int:
    """Bytes a packed conv's taps read at batch n: (oh + kh - 1) x
    (ow + kw - 1) pixels of each input, all its lanes, and the sum
    operand's image pixels. The halo rows and columns past them are never
    read."""
    c = op.cfg
    px = n * (c.oh + c.kh - 1) * (c.ow + c.kw - 1)
    return sum(px * s.cp for s in op.sins) + (
        0 if op.ssum is None else n * c.oh * c.ow * op.ssum.cp)


def conv_ops(cfg, n=None) -> float:
    """2 x the multiply-adds of a conv config (+ its fused 1x1)."""
    per_px = cfg.kh * cfg.kw * cfg.ic * cfg.oc + (
        cfg.oc * cfg.oc1x1 if cfg.fuse_conv1x1 else 0)
    return 2.0 * (n or cfg.bs) * cfg.oh * cfg.ow * per_px


def bound_ms(nbytes_: float, ops: float, tensor: bool = True):
    """(ms, what binds): the larger of bytes over HBM rate and operations
    over the peak rate of their type (int8 tensor cores, or the CUDA
    cores for elementwise work)."""
    t_b = nbytes_ / (H100_HBM_TBS * 1e12) * 1e3
    rate = H100_INT8_PEAK_TOPS if tensor else H100_CORE_TOPS
    t_o = ops / (rate * 1e12) * 1e3
    return (t_o, "operations") if t_o > t_b else (t_b, "bytes")


# ------------------------------------------------------ trees, in turns

def make_tree(base, name, edits):
    """base/name: a copy of this checkout's package with the edits (file
    under csrc/, old text, new text) applied. An edit whose old text is no
    longer in the source stops the script, so a variant follows the kernel
    or fails loudly."""
    tree = os.path.join(base, name)
    pkg = os.path.join(tree, "deepfusion_tpu_torch")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "deepfusion_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in edits:
        path = os.path.join(pkg, "csrc", fname)
        with open(path) as f:
            src = f.read()
        if old not in src:
            sys.exit(f"{name}: the edit's text is not in {fname}: {old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return tree


def variant_trees(name, variants):
    """{"kernel": this checkout, variant: its tree under
    chip_checkout/<name>/ (which .gitignore lists)} for an ablation's
    variants ({variant: edits})."""
    base = os.path.join(ROOT, "chip_checkout", name)
    trees = {"kernel": ROOT}
    trees.update({v: make_tree(base, v, e) for v, e in variants.items()})
    return trees


def child(module, tree):
    """One run: ``module.run_tree(tree)`` (a tool under tools/) with the
    tree's package ahead of every other; its entries as the last line."""
    sys.path.insert(0, tree)
    res = importlib.import_module(module).run_tree(tree)
    print(json.dumps({"tree": tree, "entries": res}), flush=True)


def run_trees(module, trees):
    """Time ``module.run_tree`` ({entry: number}) on each tree ({name:
    root}: this checkout, an unpacked commit such as chip_checkout/parent,
    a variant of make_tree), each run in its own process, which imports
    and builds that tree's package. The trees build at once, one process
    each; then they run in turns, in the order given and back (A, B, ...,
    ..., B, A). Prints each run's tree and seconds, the card, then each
    entry's median per tree and its ratio to the first tree's."""
    roots = {k: os.path.abspath(v) for k, v in trees.items()}
    code = "from deepfusion_tpu_torch import _build; _build.kernels()"
    builds = [subprocess.Popen([sys.executable, "-c", code], cwd=r)
              for r in dict.fromkeys(roots.values())]
    for p in builds:
        if p.wait():
            sys.exit(f"a build failed (exit {p.returncode})")
    names = list(roots)
    runs = {k: [] for k in names}
    for name in names + names[::-1]:
        run = (f"import sys; sys.path.insert(0, {TOOLS!r}); import oncard; "
               f"oncard.child({module!r}, {roots[name]!r})")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", run], cwd=roots[name],
                             stdout=subprocess.PIPE, text=True)
        if out.returncode:
            print(out.stdout[-4000:])
            sys.exit(f"the run of {name} failed (exit {out.returncode})")
        runs[name].append(json.loads(out.stdout.splitlines()[-1])["entries"])
        print(f"run: {name} ({roots[name]}) {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"card: {card()}")
    for entry in runs[names[0]][0]:
        meds = {}
        for k, rs in runs.items():
            vals = [r[entry] for r in rs if entry in r
                    and not np.isnan(r[entry])]
            meds[k] = statistics.median(vals) if vals else float("nan")
        print(f"{entry}: " + " ".join(
            f"{k}={m:.5g}({m / meds[names[0]]:.3f})"
            for k, m in meds.items()), flush=True)
