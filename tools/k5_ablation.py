"""Where the packed conv kernel (K5, csrc/packed_conv.cu) spends its time:
the kernel against copies of itself with one part taken out, on one card.

    python3 tools/k5_ablation.py

Times ``packed_conv_cuda`` (``oncard.device_ms``: median of 3 profiles
of 30 calls) at bench.py's default shape and at FusionNet's and
ResFusionNet's packed layers, in the checkout and in a copy per variant
under chip_checkout/k5_ablation/, in turns (``oncard.run_trees``).

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
import oncard

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


def run_tree(tree):
    """{layer: device ms} at the package first on sys.path (the tree's)."""
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
        fop, fb, _ = oncard.flagship_op(dev)
        fx = oncard.packed_input(rng, fop.sin, fb, dev)
        res["bench.py default"] = oncard.device_ms(
            lambda: PK.packed_conv_cuda(fop, [fx]), reps=30, profiles=3)
        del fop, fx
        for model in (FusionNet(FusionNetConfig(), device=dev),
                      ResFusionNet(ResFusionNetConfig(), device=dev)):
            n = model.cfg.batch
            for name, op in model.build_packed().items():
                arrs = [oncard.packed_input(rng, s, n, dev) for s in op.sins]
                sm = None if op.ssum is None else oncard.packed_input(
                    rng, op.ssum, n, dev)
                res[f"{type(model).__name__} {name}"] = oncard.device_ms(
                    lambda: PK.packed_conv_cuda(op, arrs, sm), reps=30,
                    profiles=3)
    return res


if __name__ == "__main__":
    oncard.run_trees("k5_ablation",
                     oncard.variant_trees("k5_ablation", VARIANTS))
