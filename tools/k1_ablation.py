"""Where the dense conv kernel (K1, conv_fused_kernel<FUSE, DST> in
csrc/conv.cu) spends its time at ResNet-50's 1-byte-dst layers with a
final-stage requant other than plain u8: the kernel against copies of
itself with one part taken out, on one card.

    python3 tools/k1_ablation.py [PARENT]

Times ``conv_cuda`` (``oncard.device_ms``: median of 3 profiles of 30
calls) at batch 256 of ResNet50(ResNet50Config()) layers: one fused block
(K1b) of each stage with a u8 shortcut, stage 2's first block (stride 2,
the projection's s8 shortcut), and the four projections (K1a, 1x1 to s8,
no sum), on full-range inputs and sum operands, in the checkout and in a
copy per variant under chip_checkout/k1_ablation/, in turns
(``oncard.run_trees``). PARENT, a tree such as ``chip_checkout/parent``
(``git archive`` of a commit unpacked there), runs beside them unchanged.

Variants:
  no_sum_load   the sum operand is never read: load_sum returns its scale,
                and the tiled path issues no copy (its epilogue reads
                whatever the staging rows hold)
  no_epilogue   write_mid, write_bytes and write_words return at once
  no_wgmma      wgmma_step issues nothing
  no_round      the final stage's requant into an s8 dst or with a 1-byte
                sum (requant_int) returns a plain truncation, the
                accumulator plus the sum byte: no conversion, no float
                operation, no rounding, no clamp
"""
import sys

import oncard

CU, RQ, WG = "conv.cu", "requant.cuh", "wgmma_tma.cuh"
LAYERS = ("s1b2_fused", "s2b1_fused", "s2b2_fused", "s3b2_fused",
          "s4b2_fused", "s1b1_proj", "s2b1_proj", "s3b1_proj", "s4b1_proj")
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
    "no_round": [
        (RQ, "bool has_sum, int v, float sum_scale) {\n",
         "bool has_sum, int v, float sum_scale) {\n"
         "  return typename dt_traits<DT>::T(acc + v);\n")],
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
            sm = oncard.rand(rng, (BATCH, c.oh, c.ow, c.out_oc), c.sum_dt,
                             dev) if c.with_sum else None
            what = f"sum {c.sum_dt.name}" if c.with_sum else \
                f"dst {c.dst_dt.name}"
            res[f"{name} {what}"] = oncard.device_ms(
                lambda: K.conv_cuda(op, x, sm), reps=30, profiles=3)
    return res


if __name__ == "__main__":
    trees = oncard.variant_trees("k1_ablation", VARIANTS)
    if len(sys.argv) > 1:
        trees["parent"] = sys.argv[1]
    oncard.run_trees("k1_ablation", trees)
