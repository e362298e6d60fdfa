"""Where the packed conv kernel (K5, csrc/packed_conv.cu) spends its time:
the kernel against copies of itself with one part taken out, on one card.

    python3 tools/k5_ablation.py [--dir DIR]

Copies this checkout's deepfusion_tpu_torch into DIR/<variant> (default
chip_checkout/ablation, which .gitignore lists), applies each variant's
source edits, then times ``packed_conv_cuda`` of the checkout and of every
variant, each tree in its own process (building its own kernels), in turns:
the checkout, the variants, the variants in reverse, the checkout. Each
time is ``chip_smoke.device_ms`` (median of 3 profiles of 30 calls) at
bench.py's default shape and at FusionNet's and ResFusionNet's packed
layers. A variant computes wrong values: only its time means anything.
An edit whose text is no longer in the source stops the script, so the
variants follow the kernel or fail loudly.

Variants:
  no_epilogue       write_mid, write_out, write_acc and write_merge
                    return at once
  no_wgmma          wgmma_step issues nothing
  no_a_loads        the producer loads no activation box
  no_b_loads        the producer loads no 3x3 weight box
  trivial_requant   a byte of the accumulator instead of the requant, no
                    parameter loads; every store as in the kernel (the
                    merge instance keeps its requant)
  no_global_stores  the final stage stages and reads back, stores nothing
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

CU, WG = "packed_conv.cu", "wgmma_tma.cuh"
VARIANTS = {
    "no_epilogue": [
        (CU, "int nb, int m0, const Pix& px) {\n",
         "int nb, int m0, const Pix& px) {\n  if (n0 >= 0) return;\n"),
        (CU, "int nn, const Pix& px, uint8_t* stage, int m0) {\n",
         "int nn, const Pix& px, uint8_t* stage, int m0) {\n"
         "  if (n0 >= 0) return;\n"),
        (CU, "int nb, int nn, const Pix& px) {\n",
         "int nb, int nn, const Pix& px) {\n  if (n0 >= 0) return;\n"),
        (CU, "const uint8_t* ring, int s0,\n"
             "                                            int m0) {\n",
         "const uint8_t* ring, int s0,\n"
         "                                            int m0) {\n"
         "  if (n0 >= 0) return;\n")],
    "no_wgmma": [
        (WG, "int nb, int scale_d) {\n  switch (nb) {",
         "int nb, int scale_d) {\n  if (nb > 0) return;\n  switch (nb) {")],
    "no_a_loads": [
        (CU, "uint8_t* s = slot((TM + p.nb0) * kc);\n"
             "            tma_load_4d(",
         "uint8_t* s = slot(p.nb0 * kc);\n            if (kc < 0) "
         "tma_load_4d(")],
    "no_b_loads": [
        (CU, "uint8_t* s = slot((TM + p.nb0) * kc);",
         "uint8_t* s = slot(TM * kc);"),
        (CU, "            tma_load_2d(s + p.slot_a, &maps.b0[ch.wcode], "
             "&full[stage],",
         "            if (kc < 0) tma_load_2d(s + p.slot_a, "
         "&maps.b0[ch.wcode], &full[stage],")],
    "trivial_requant": [
        (CU, "u = requant_u8(x, be, se, down);", "u = uint32_t(x) & 0xffu;"),
        (CU, "const float2 b = *reinterpret_cast<const float2*>(bias + o);",
         "const float2 b = make_float2(0.0f, 0.0f);"),
        (CU, "const float2 sc = *reinterpret_cast<const float2*>(scale + o);",
         "const float2 sc = b;"),
        (CU, "const int2 c = corr ?", "const int2 c = false ?")],
    "no_global_stores": [
        (CU, "*reinterpret_cast<uint4*>(d.dst + (size_t)slot * d.cp + n0 + "
             "16 * gi) = v;",
         'asm volatile("" ::"r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), '
         '"r"(slot));')],
}


def make_tree(base, name, edits):
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


def run_tree(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import importlib

    import numpy as np
    import torch
    from deepfusion_tpu_torch.models import (FusionNet, FusionNetConfig,
                                             ResFusionNet, ResFusionNetConfig)
    PK = importlib.import_module("deepfusion_tpu_torch.ops.packed")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    res = {}
    with torch.inference_mode():
        fop, fb, _ = cs.flagship_op(dev)
        fx = cs.packed_input(rng, fop.sin, fb, dev)
        res["bench.py default"] = cs.device_ms(
            lambda: PK.packed_conv_cuda(fop, [fx]), reps=30, profiles=3)
        del fop, fx
        for model in (FusionNet(FusionNetConfig(), device=dev),
                      ResFusionNet(ResFusionNetConfig(), device=dev)):
            n = model.cfg.batch
            for name, op in model.build_packed().items():
                arrs = [cs.packed_input(rng, s, n, dev) for s in op.sins]
                sm = None if op.ssum is None else cs.packed_input(
                    rng, op.ssum, n, dev)
                res[f"{type(model).__name__} {name}"] = cs.device_ms(
                    lambda: PK.packed_conv_cuda(op, arrs, sm), reps=30,
                    profiles=3)
    print(json.dumps({"tree": tree, "device_ms": res}), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run_tree(sys.argv[2])
        return
    base = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--dir" \
        else os.path.join(ROOT, "chip_checkout", "ablation")
    trees = {"kernel": ROOT}
    trees.update({name: make_tree(base, name, edits)
                  for name, edits in VARIANTS.items()})
    order = list(trees) + list(trees)[::-1]
    runs = {}
    for name in order:
        out = subprocess.run([sys.executable, __file__, "--run",
                              trees[name]], capture_output=True, text=True,
                             check=True)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.setdefault(name, []).append(json.loads(line)["device_ms"])
    print(f"card: {cs.card()}")
    for entry in runs["kernel"][0]:
        meds = {n: statistics.median(r[entry] for r in rs)
                for n, rs in runs.items()}
        print(f"{entry}: " + " ".join(
            f"{n}={m:.5f}({m / meds['kernel']:.3f})" for n, m in meds.items()))


if __name__ == "__main__":
    main()
