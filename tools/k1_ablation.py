"""Where the dense conv kernel's fused instance (K1b, conv_fused_kernel<true,
DST> in csrc/conv.cu) spends its time at ResNet-50's bottlenecks: the kernel
against copies of itself with one part taken out, on one card.

    python3 tools/k1_ablation.py

Times ``conv_cuda`` (``oncard.device_ms``: median of 3 profiles of 30
calls) at batch 256 of ResNet50(ResNet50Config()) fused layers: one
identity block of each stage (a u8 shortcut) and stage 2's first block
(stride 2, the projection's s8 shortcut), on full-range inputs and sum
operands, in the checkout and in a copy per variant under
chip_checkout/k1_ablation/, in turns (``oncard.run_trees``).

Variants:
  no_sum_load   the sum operand is never read: load_sum returns its scale,
                and the tiled path issues no copy (its epilogue reads
                whatever the staging rows hold)
  no_epilogue   write_mid, write_bytes and write_words return at once
  no_wgmma      wgmma_step issues nothing
"""
import oncard

CU, RQ, WG = "conv.cu", "requant.cuh", "wgmma_tma.cuh"
LAYERS = ("s1b2_fused", "s2b1_fused", "s2b2_fused", "s3b2_fused",
          "s4b2_fused")
BATCH = 256
VARIANTS = {
    "no_sum_load": [
        (RQ, "int dt, float scale) {\n  float v;\n",
         "int dt, float scale) {\n  if (dt >= 0) return scale;\n"
         "  float v;\n"),
        (CU, "  if (spix < 0 || col0 >= oc) return;\n",
         "  if (col0 >= 0) return;\n")],
    "no_epilogue": [
        (CU, "const int32_t (&acc)[128], int col0,\n"
             "                                          int nbw, int m0) {\n",
         "const int32_t (&acc)[128], int col0,\n"
         "                                          int nbw, int m0) {\n"
         "  if (col0 >= 0) return;\n"),
        (CU, "const long long (&pix)[2], long long spix, uint8_t* stage, "
             "int m0) {\n  const int lane",
         "const long long (&pix)[2], long long spix, uint8_t* stage, "
         "int m0) {\n  if (col0 >= 0) return;\n  const int lane"),
        (CU, "const long long (&pix)[2]) {\n  using T",
         "const long long (&pix)[2]) {\n  if (col0 >= 0) return;\n"
         "  using T")],
    "no_wgmma": [
        (WG, "int nb, int scale_d) {\n  switch (nb) {",
         "int nb, int scale_d) {\n  if (nb > 0) return;\n  switch (nb) {")],
}


def run_tree(tree):
    """{layer: device ms} at the package first on sys.path (the tree's)."""
    import importlib

    import numpy as np
    import torch
    from deepfusion_tpu_torch.models import ResNet50, ResNet50Config
    from deepfusion_tpu_torch.types import dtype
    K = importlib.import_module("deepfusion_tpu_torch.ops.conv")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    net = ResNet50(ResNet50Config(batch=BATCH), device=dev)
    res = {}
    with torch.inference_mode():
        for name in LAYERS:
            op = net.convs[name]
            c = op.cfg
            x = oncard.rand(rng, (BATCH, c.ih, c.iw, c.ic), dtype.u8, dev)
            sm = oncard.rand(rng, (BATCH, c.oh, c.ow, c.out_oc), c.sum_dt, dev)
            res[f"{name} sum {c.sum_dt.name}"] = oncard.device_ms(
                lambda: K.conv_cuda(op, x, sm), reps=30, profiles=3)
    return res


if __name__ == "__main__":
    oncard.run_trees("k1_ablation",
                     oncard.variant_trees("k1_ablation", VARIANTS))
