"""The concat+ReLU kernel (K2, csrc/concat.cu) and the packed sum/pool
kernel (K6/K8, csrc/packed_sum_pool.cu ``packed_sum_pool_kernel``) against
versions of themselves that stage their tiles in shared memory, on one card.

    python3 tools/stage_ab.py [--dir DIR] [--parent TREE]

Copies this checkout's deepfusion_tpu_torch into DIR (default
chip_checkout/stage_ab, which .gitignore lists) as two variant trees:

  staged  csrc/concat.cu replaced by tools/stage_variants/concat_staged.cu
          (each input's slice of a tile of whole output rows staged in
          shared memory with 16-byte loads, then stored as one run), and
          packed_sum_pool_kernel with its launch_sum<POOL, G> replaced by
          tools/stage_variants/packed_sum_staged.cu (the tile's runs of every
          input and of r staged, summed from shared memory into a staged
          output tile, stored as 16-byte units)
  bulk    as staged, K2's slices staged by 1-D bulk copies (cp.async.bulk
          on an mbarrier; the variant's STAGE_BULK)

Builds the kernels of this checkout ("shipped"), of the variants and of
TREE ("parent", e.g. ``git archive`` of the parent commit unpacked into
chip_checkout/parent) all at once, one process per tree, then runs each
tree in its own process in turns: parent, shipped, staged, bulk, bulk,
staged, shipped, parent. A run first holds every case bitwise against the
plain version (``concat_plain``, ReLU on and off; ``packed_sum_pool_plain``),
then times each warm and cold (``chip_smoke.device_ms`` and
``cold_device_ms``, medians of 3 profiles of 20 calls); the shipped runs also
time ``torch.cat`` of K2's inputs. The cases: K2 at FusionNet's branch
merge (8x56x56, two u8 inputs of 128 channels, ReLU), 17 and 40 u8 inputs
of 16-48 channels at 8x56x56, and the reference's three s8 sets at batch 4
(bench.py:450-451); K8 at FusionNet's packed residual (sum and pool), K6
there (the sum of the joined 256 lanes) and K8 at the three C13 shapes of
``chip_smoke.c13_sum_pool_cases`` at 56x56 (the bulk tree skips K6/K8: its
sum kernel is the staged one). Prints one JSON line per run, then per case
each tree's median warm / cold ms, the bound (bytes over 3.35 TB/s) with
the cold share, and each tree's ratio to the shipped one. A variant file
whose anchors are no longer in the source stops the script.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (this checkout's; imports no package)

VARIANTS = os.path.join(ROOT, "tools", "stage_variants")
# (start, end) anchors of the shipped text that the staged sum kernel
# replaces (the kernel) and removes (its launch_sum<POOL, G>; the variant
# brings its own)
SUM_KERNEL = ("template <bool POOL, int G>\n__global__ void "
              "__launch_bounds__(NT)\n    packed_sum_pool_kernel(",
              "constexpr int POOL_BYTES")
SUM_LAUNCH = ("template <bool POOL, int G>\ncudaError_t launch_sum(",
              "template <bool POOL>\ncudaError_t launch_sum(")
BULK = ("constexpr bool STAGE_BULK = false;",
        "constexpr bool STAGE_BULK = true;")


def k2_cases():
    """(label, dtype name, input shapes) of K2."""
    nhw = (8, 56, 56)
    out = [("K2 branch merge", "u8", [nhw + (128,)] * 2)]
    for n_in in (17, 40):
        out.append((f"K2 {n_in} inputs", "u8",
                    [nhw + (16 * (1 + i % 3),) for i in range(n_in)]))
    for hw, chans in cs.CONCAT_SETS.items():
        out.append((f"K2 reference {hw}x{hw}", "s8",
                    [(4, hw, hw, c) for c in chans]))
    return out


def cut(src, anchors, new, what):
    start, end = anchors
    if src.count(start) != 1 or src.count(end) != 1:
        sys.exit(f"{what}: the anchors are not once each in the source: "
                 f"{start!r} ... {end!r}")
    i, j = src.index(start), src.index(end)
    if j < i:
        sys.exit(f"{what}: the anchors are out of order")
    return src[:i] + new + src[j:]


def make_trees(base):
    """{name: tree} of the variant trees, written under base."""
    with open(os.path.join(VARIANTS, "concat_staged.cu")) as f:
        k2 = f.read()
    with open(os.path.join(VARIANTS, "packed_sum_staged.cu")) as f:
        k8 = f.read()
    if BULK[0] not in k2:
        sys.exit(f"concat_staged.cu: {BULK[0]!r} is not in it")
    trees = {}
    for name, k2_src in (("staged", k2), ("bulk", k2.replace(*BULK))):
        tree = os.path.join(base, name)
        pkg = os.path.join(tree, "deepfusion_tpu_torch")
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "deepfusion_tpu_torch"), pkg,
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        csrc = os.path.join(pkg, "csrc")
        with open(os.path.join(csrc, "concat.cu"), "w") as f:
            f.write(k2_src)
        path = os.path.join(csrc, "packed_sum_pool.cu")
        with open(path) as f:
            src = f.read()
        src = cut(src, SUM_LAUNCH, "", "launch_sum")
        src = cut(src, SUM_KERNEL, k8, "packed_sum_pool_kernel")
        with open(path, "w") as f:
            f.write(src)
        trees[name] = tree
    return trees


def run_tree(tree, name):
    sys.path.insert(0, os.path.abspath(tree))
    import importlib

    import numpy as np
    import torch
    from deepfusion_tpu_torch.config import ConcatConfig
    from deepfusion_tpu_torch.models import FusionNet, FusionNetConfig
    from deepfusion_tpu_torch.types import dtype
    C = importlib.import_module("deepfusion_tpu_torch.ops.concat")
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    res = {}

    def timed(label, fn, nbytes):
        res[label] = (cs.device_ms(fn, profiles=3), cs.cold_device_ms(fn),
                      nbytes / (cs.H100_HBM_TBS * 1e9))

    with torch.inference_mode():
        for label, dt_name, shapes in k2_cases():
            dt = getattr(dtype, dt_name)
            xs = [cs.rand(rng, s, dt, dev) for s in shapes]
            for relu in (False, True):
                cfg = ConcatConfig.make(shapes, dt, relu)
                got = C.concat_cuda(xs, cfg)
                if not torch.equal(got, C.concat_plain(xs, cfg)):
                    sys.exit(f"{tree}: {label} relu={relu} is not bitwise "
                             f"its plain version")
            out_bytes = got.numel() * got.element_size()
            timed(label, lambda: C.concat_cuda(xs, cfg), 2 * out_bytes)
            if name == "shipped":
                timed(f"torch.cat {label[3:]}",
                      lambda: torch.cat(xs, dim=-1), 2 * out_bytes)
            del xs, got
        if name != "bulk":
            pk = FusionNet(FusionNetConfig(), device=dev).build_packed()
            rs = pk["res"].sout
            cases = [("FusionNet residual",
                      [pk["block1"].sout, pk["branch"].sout], rs, 8)]
            cases += [c for c in cs.c13_sum_pool_cases()
                      if c[0].startswith("C13 56x56")]
            for label, ys_s, rs, bn in cases:
                ys = [cs.packed_input(rng, s, bn, dev) for s in ys_s]
                rr = cs.packed_input(rng, rs, bn, dev)
                runs = [(f"K8 {label}", ys, True)]
                if label == "FusionNet residual":
                    runs.append((f"K6 {label}", [torch.cat(ys, dim=-1)],
                                 False))
                for what, yy, pool in runs:
                    args = (yy, rr, pool, rs.rows, rs.iwp)
                    got = PK.packed_sum_pool_cuda(*args)
                    if not torch.equal(got, PK.packed_sum_pool_plain(*args)):
                        sys.exit(f"{tree}: {what} is not bitwise its plain "
                                 f"version")
                    nbytes = sum(t.numel() for t in yy) + rr.numel() + \
                        got.numel()
                    timed(what, lambda: PK.packed_sum_pool_cuda(*args),
                          nbytes)
    print(json.dumps({"tree": tree, "name": name, "ms": res}), flush=True)


def build(tree):
    """A process that builds (or finds) the tree's kernels."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from deepfusion_tpu_torch import _build; _build.kernels()")
    return subprocess.Popen([sys.executable, "-c", code,
                             os.path.abspath(tree)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def main():
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--run":
        run_tree(args[1], args[2])
        return
    base = os.path.join(ROOT, "chip_checkout", "stage_ab")
    parent = None
    while args:
        flag, value, args = args[0], args[1], args[2:]
        if flag == "--dir":
            base = value
        elif flag == "--parent":
            parent = value
        else:
            sys.exit(__doc__)
    trees = {"shipped": ROOT, **make_trees(base)}
    order = ["shipped", "staged", "bulk"]
    if parent:
        trees["parent"] = parent
        order = ["parent"] + order
    builds = {n: build(t) for n, t in trees.items()}
    for n, p in builds.items():
        out, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{n}: the build failed (exit {p.returncode})\n"
                     f"{out[-6000:]}")
    runs = {}
    for name in order + order[::-1]:
        out = subprocess.run([sys.executable, __file__, "--run",
                              trees[name], name], capture_output=True,
                             text=True)
        if out.returncode:
            sys.exit(f"{name}: exit {out.returncode}\n{out.stderr[-3000:]}"
                     f"\n{out.stdout[-2000:]}")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.setdefault(name, []).append(json.loads(line)["ms"])
    print(f"card: {cs.card()}")
    labels = list(runs["shipped"][0])
    for label in labels:
        med = {n: [statistics.median(r[label][k] for r in rs)
                   for k in (0, 1)] for n, rs in runs.items()
               if label in rs[0]}
        bound = runs["shipped"][0][label][2]
        ship = med.get("shipped")
        print(f"{label}: bound {bound:.5f} ms; " + "; ".join(
            f"{n} {w:.5f} / {c:.5f} ({bound / c:.0%} cold)"
            + (f", x{w / ship[0]:.3f} / x{c / ship[1]:.3f} of shipped"
               if ship and n != "shipped" else "")
            for n, (w, c) in med.items()), flush=True)


if __name__ == "__main__":
    main()
