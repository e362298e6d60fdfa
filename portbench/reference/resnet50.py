"""ResNet-50 v1.5, plain: a 7x7/s2 stem and a 3x3/s2 max pool, four stages
of bottleneck blocks (3, 4, 6 and 3 blocks of widths w, 2w, 4w and 8w, each
1x1 reduce -> 3x3 -> 1x1 expand to 4x the width, plus the shortcut, then
ReLU), a global average pool and the classifier (He et al., "Deep Residual
Learning for Image Recognition", arXiv:1512.03385, Table 1, the 50-layer
column; v1.5 strides each down-sampling block's 3x3, not its reduce, as
torchvision's ``resnet50`` and MLPerf Inference's ``resnet50-v1.5`` do).

Departures from the published model, all of them the int8 engine's:

* BatchNorm is folded into each conv's bias and per-channel scale;
* the input is raw u8 NHWC images, with no mean and std step;
* a projection shortcut (the 1x1 of each stage's first block) requantizes
  to s8, with no ReLU, and joins the expand's epilogue as an s8 operand;
  an identity shortcut joins as the block input's u8;
* the expand's sum is the engine's post-op: ``round(x) + round(sum * s)``,
  then ReLU, then saturation to u8, with the sum scale s = 1.0;
* the global average pool rounds to u8 (half to even) before the head;
* the fully connected head is a 1x1 conv with an f32 output;
* the weights are random and seeded (``portbench/weights.py``).

The arithmetic that ``ops.py`` lacks is here: the s8 requant, the sum
post-op, the 3x3/s2/p1 max pool (floor mode, as torchvision's) and an exact
accumulator for convs whose sums float32 cannot hold (stage 4's 3x3s over
512 channels): each part of the input channels is exact in float32, and
the parts add in float64.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import ops

BLOCKS = (3, 4, 6, 3)    # bottleneck blocks per stage
EXPANSION = 4            # a block's output over its width
SUM_SCALE = 1.0          # the shortcut's scale in the expand's epilogue
# The weights' calibration (``weights.draw``: scales of 48 over the
# accumulator's spread, which the input's rms sets): the rms of u8 images
# uniform over 0..255, of the stem's pooled output, and of the residual
# stream after one block; the stream's rms grows about as the square root
# of the blocks summed into it since the last projection.
IMAGE_RMS, POOL_RMS, BLOCK_RMS = 147.0, 55.0, 50.0


def in_std(stage: int, block: int) -> float:
    """The rms of the residual stream that a block's reduce (and the first
    block's projection) reads: the stem's pooled output, or the stream
    after the blocks summed into it since the last projection (all of the
    previous stage's, in a stage's first block)."""
    if (stage, block) == (1, 1):
        return POOL_RMS
    summed = BLOCKS[stage - 2] if block == 1 else block - 1
    return BLOCK_RMS * summed ** 0.5


def layers(cfg: dict) -> list:
    """The layers of ``cfg`` (hw, in_ch, width, num_classes) in the order
    the weights are drawn and the forward runs them: name, kernel, input
    and output channels, the fused 1x1's channels, the output resolution
    ``hw`` (the stem's ``pool`` 2 is the max pool after it), the stride,
    destination, ReLU, the input spread the weights are calibrated for,
    and a fused layer's shortcut operand ``sum_dt`` (s8 from a projection,
    else the block input's u8; None elsewhere)."""
    hw, c, w = cfg["hw"], cfg["in_ch"], cfg["width"]

    def layer(name, k, ic, oc, h, stride=1, oc1=None, dst="u8",
              relu=True, std=30.0, sum_dt=None):
        return dict(name=name, k=k, ic=ic, oc=oc, oc1x1=oc1, hw=h, pool=1,
                    stride=stride, dst=dst, relu=relu, in_std=std,
                    sum_dt=sum_dt)
    out = [dict(layer("stem", 7, c, w, hw // 2, stride=2, std=IMAGE_RMS),
                pool=2)]
    cin, res = w, hw // 4
    for s, n_blocks in enumerate(BLOCKS, start=1):
        width = w << (s - 1)
        cout = EXPANSION * width
        for b in range(1, n_blocks + 1):
            stride = 2 if s > 1 and b == 1 else 1
            ores = res // stride
            std = in_std(s, b)
            out.append(layer(f"s{s}b{b}_reduce", 1, cin, width, res,
                             std=std))
            if b == 1:
                out.append(layer(f"s{s}b1_proj", 1, cin, cout, ores, stride,
                                 dst="s8", relu=False, std=std))
            out.append(layer(f"s{s}b{b}_fused", 3, width, width, ores,
                             stride, oc1=cout,
                             sum_dt="s8" if b == 1 else "u8"))
            cin, res = cout, ores
    out.append(layer("head", 1, cin, cfg["num_classes"], 1, dst="f32",
                     relu=False))
    return out


def conv_acc_exact(x: torch.Tensor, wei: np.ndarray, stride: int = 1
                   ) -> torch.Tensor:
    """``ops.conv_acc`` for any int8 weights: the input channels in parts
    whose sums float32 holds exactly, each part's accumulator added in
    float64. (n, oh, ow, oc) float64 holding the s32 sums."""
    oc, ic, k, _ = wei.shape
    peak = max(int(np.abs(wei.astype(np.int64)).max()), 1) * 255 * k * k
    step = max(1, (ops.EXACT - 1) // peak)
    acc = None
    for c0 in range(0, ic, step):
        part = ops.conv_acc(x[..., c0:c0 + step], wei[:, c0:c0 + step],
                            stride).to(torch.float64)
        acc = part if acc is None else acc + part
    return acc


def requant_s8(acc: torch.Tensor, bias: np.ndarray, scale: np.ndarray
               ) -> torch.Tensor:
    """``f32(acc) + f32(bias)``, ``* f32(scale)``, round half to even,
    saturate to [-128, 127]; no ReLU."""
    x = ops.requant(acc, bias, scale, False, "f32")
    return torch.round(x).clamp(-128.0, 127.0)


def requant_sum_u8(acc: torch.Tensor, bias: np.ndarray, scale: np.ndarray,
                   shortcut: torch.Tensor) -> torch.Tensor:
    """The expand's epilogue in the engine's order: ``round((f32(acc) +
    bias) * scale) + round(shortcut * SUM_SCALE)``, then ReLU, then
    saturation to u8."""
    x = torch.round(ops.requant(acc, bias, scale, False, "f32"))
    x = x + torch.round(shortcut * np.float32(SUM_SCALE))
    return torch.clamp_min(x, 0.0).clamp(0.0, 255.0)


def maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, padding 1, floor mode. The values are u8
    after a ReLU, so zero padding is the max's identity."""
    n, h, w, c = x.shape
    oh, ow = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for ki in range(3):
        for kj in range(3):
            tap = xp[:, ki:ki + 2 * (oh - 1) + 1:2,
                     kj:kj + 2 * (ow - 1) + 1:2, :]
            out = tap if out is None else torch.maximum(out, tap)
    return out


def conv_layer(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    """A conv without a fused 1x1: u8 (with ReLU), s8 or f32 out."""
    acc = conv_acc_exact(x, p["wei"], stride).to(torch.float32)
    if p["dst_dt"] == "s8":
        return requant_s8(acc, p["bia"], p["conv0_scales"])
    return ops.requant(acc, p["bia"], p["conv0_scales"],
                       bool(p["conv0_relu"]), p["dst_dt"])


def fused_layer(x: torch.Tensor, p: dict, stride: int,
                shortcut: torch.Tensor) -> torch.Tensor:
    """The block's 3x3 (u8 intermediate, ReLU) and its 1x1 expand with the
    shortcut joined in the epilogue."""
    acc = conv_acc_exact(x, p["wei"], stride).to(torch.float32)
    mid = ops.requant(acc, p["bia"], p["conv0_scales"], True, "u8")
    acc1 = conv_acc_exact(mid, p["wei1"]).to(torch.float32)
    return requant_sum_u8(acc1, p["bia1"], p["conv1_scales"], shortcut)


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (n, classes) float32 of u8 images x (n, hw, hw, in_ch)."""
    y = maxpool3s2(conv_layer(x.to(torch.float32), params["stem"], 2))
    for s, n_blocks in enumerate(BLOCKS, start=1):
        for b in range(1, n_blocks + 1):
            stride = 2 if s > 1 and b == 1 else 1
            r = conv_layer(y, params[f"s{s}b{b}_reduce"], 1)
            if b == 1:
                y = conv_layer(y, params[f"s{s}b1_proj"], stride)
            y = fused_layer(r, params[f"s{s}b{b}_fused"], stride, y)
    return ops.head(ops.global_avgpool_u8(y), params["head"])
