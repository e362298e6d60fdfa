"""MobileNetV2 (width 1.0), plain: a 3x3/s2 conv to 32 channels, 17
inverted residual blocks in seven groups, a 1x1 conv to 1,280 channels, a
global average pool and the classifier (Sandler et al., "MobileNetV2:
Inverted Residuals and Linear Bottlenecks", arXiv:1801.04381, Table 2;
torchvision's ``mobilenet_v2``). A block expands its input t times by a
1x1 (none where t is 1), runs a 3x3 depthwise conv at the block's stride,
and projects linearly by a 1x1 with no activation; where the stride is 1
and the input and output channels are equal, the block input is added to
the projection, with no activation after the sum.

Departures from the published model, all of them the int8 engine's or
inference's, as integer-only MobileNetV2 runs it (Jacob et al.,
arXiv:1712.05877; TFLite's ``mobilenet_v2_1.0_224_quant``):

* ReLU6 is the u8 saturation: each conv followed by ReLU6 requantizes to
  u8 with ReLU, its output scale mapping 6.0 to 255, so the clip at 6 is
  the clamp at 255;
* the linear bottlenecks (each projection, and so the residual stream)
  are s8, with no ReLU; the expands and the last 1x1 read them as an s8
  source;
* the residual sum is the engine's post-op into s8: ``round(x) +
  round(sum * SUM_SCALE)``, saturated to [-128, 127], no ReLU, with the
  sum scale 1.0;
* batch norm is folded into each conv's bias and per-channel scale, and
  the input is raw u8 NHWC images, with no mean and std step;
* dropout is the identity at inference, and the forward ends at the
  logits, with no softmax;
* the global average pool rounds to u8 (half to even) before the head,
  and the fully connected head is a 1x1 conv with an f32 output;
* the weights are random and seeded (``portbench/weights.py``).

Every accumulator is exact in float32 (the largest, the head's 1x1 over
1,280 channels, reaches 16 x 255 x 1,280 = 5,222,400 < 2**24), so the
dense convs are ``ops.conv_acc``'s; s8 activations travel as float32 too,
and zero padding is 0 in either domain. The depthwise accumulator is this
file's own: the nine taps' elementwise products summed in float32, exact
(9 x 255 x 16 < 2**24).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import ops

# Table 2's bottleneck groups: expansion t, output channels c, blocks n,
# the first block's stride s
GROUPS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
STEM_CH, LAST_CH = 32, 1280
SUM_SCALE = 1.0          # the block input's scale in the projection's sum
# The rms the weights are calibrated for (``weights.draw``'s in_std),
# measured layer by layer on the calibrated network at 224x224 (two seeds):
# u8 images uniform over 0..255; a dense conv's u8 output after ReLU (the
# stem's and each expand's: a depthwise input); a depthwise output (a
# projection's input); the s8 stream after m projections summed into it
# since the last one without a residual (STREAM_RMS[m - 1]: about the
# square root of m, saturation aside); the global average of the last 1x1.
IMAGE_RMS, CONV_RMS, DW_RMS, AVG_RMS = 147.0, 34.5, 33.0, 29.0
STREAM_RMS = (49.0, 66.0, 75.0, 79.0)


def blocks(cfg: dict) -> list:
    """The 17 blocks in order: (name, input and output channels, expanded
    channels, stride, input resolution, the projections summed into the
    block input's s8 stream: the previous group's blocks at a group's
    first block, else the blocks of its own group before it)."""
    out, cin, hw = [], STEM_CH, -(-cfg["hw"] // 2)
    i, prev = 0, 0
    for t, c, n, s in GROUPS:
        for j in range(n):
            i += 1
            stride = s if j == 0 else 1
            out.append((f"b{i}", cin, c, cin * t, stride, hw,
                        j if j else prev))
            cin, hw = c, -(-hw // stride)
        prev = n
    return out


def residual(block) -> bool:
    """The block input joins its projection: stride 1, channels kept."""
    _, cin, cout, _, stride, _, _ = block
    return stride == 1 and cin == cout


def _layer(name, k, ic, oc, hw, *, stride=1, dst="u8", relu=True,
           std=CONV_RMS, **extra):
    return dict(name=name, k=k, ic=ic, oc=oc, oc1x1=None, hw=hw, pool=1,
                stride=stride, dst=dst, relu=relu, in_std=std, **extra)


def layers(cfg: dict) -> list:
    """The 53 layers of ``cfg`` (hw, in_ch, num_classes) in the order the
    weights are drawn and the forward runs them: name, kernel, input and
    output channels, the output resolution ``hw``, the stride, destination,
    ReLU and the input rms the weights are calibrated for. A depthwise
    layer has ``ic`` 1 (``weights.draw`` then gives it PyTorch's depthwise
    shape (c, 1, 3, 3)) and ``depthwise`` True; a layer that reads the s8
    stream has ``src_dt`` "s8"; a projection that adds the block input has
    ``sum_dt`` "s8"."""
    hw = -(-cfg["hw"] // 2)
    out = [_layer("stem", 3, cfg["in_ch"], STEM_CH, hw, stride=2,
                  std=IMAGE_RMS)]
    for blk in blocks(cfg):
        name, cin, cout, mid, stride, in_hw, summed = blk
        o_hw = -(-in_hw // stride)
        if mid != cin:
            out.append(_layer(f"{name}_expand", 1, cin, mid, in_hw,
                              std=STREAM_RMS[summed - 1], src_dt="s8"))
        out.append(_layer(f"{name}_dw", 3, 1, mid, o_hw, stride=stride,
                          depthwise=True))
        out.append(_layer(f"{name}_project", 1, mid, cout, o_hw, dst="s8",
                          relu=False, std=DW_RMS,
                          **({"sum_dt": "s8"} if residual(blk) else {})))
    out.append(_layer("last", 1, cout, LAST_CH, o_hw,
                      std=STREAM_RMS[GROUPS[-1][2] - 1], src_dt="s8"))
    out.append(_layer("head", 1, LAST_CH, cfg["num_classes"], 1, dst="f32",
                      relu=False, std=AVG_RMS))
    return out


def depthwise_acc(x: torch.Tensor, wei: np.ndarray, stride: int
                  ) -> torch.Tensor:
    """The exact accumulator of a 3x3 depthwise conv, padding 1: x (n, h,
    w, c) float32 holding u8 values, wei (c, 1, 3, 3) int8; the sum over
    the nine taps of elementwise products, float32 holding the s32 sums."""
    n, h, w, c = x.shape
    if int(np.abs(wei.astype(np.int64)).max()) * 255 * 9 >= ops.EXACT:
        raise ValueError("depthwise_acc: sums are not exact in float32")
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    wt = torch.as_tensor(wei.reshape(c, 3, 3), device=x.device).to(
        torch.float32)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for ki in range(3):
        for kj in range(3):
            term = xp[:, ki:ki + (oh - 1) * stride + 1:stride,
                      kj:kj + (ow - 1) * stride + 1:stride, :] * wt[:, ki, kj]
            acc = term if acc is None else acc + term
    return acc


def requant_s8(acc: torch.Tensor, bias: np.ndarray, scale: np.ndarray
               ) -> torch.Tensor:
    """``f32(acc) + f32(bias)``, ``* f32(scale)``, round half to even,
    saturate to [-128, 127]; no ReLU."""
    x = ops.requant(acc, bias, scale, False, "f32")
    return torch.round(x).clamp(-128.0, 127.0)


def requant_sum_s8(acc: torch.Tensor, bias: np.ndarray, scale: np.ndarray,
                   block_in: torch.Tensor) -> torch.Tensor:
    """The projection's epilogue with the block input in the engine's
    order: ``round((f32(acc) + bias) * scale) + round(block_in *
    SUM_SCALE)``, saturated to [-128, 127], no ReLU."""
    x = torch.round(ops.requant(acc, bias, scale, False, "f32"))
    x = x + torch.round(block_in * np.float32(SUM_SCALE))
    return x.clamp(-128.0, 127.0)


def conv_u8(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """A dense conv into u8 with ReLU (the source u8 or s8)."""
    return ops.requant(ops.conv_acc(x, p["wei"], stride), p["bia"],
                       p["conv0_scales"], True, "u8")


def block(params: dict, blk, x: torch.Tensor) -> torch.Tensor:
    """One inverted residual block of the s8 stream x (the stem's u8 for
    the first block)."""
    name, cin, cout, mid, stride, _, _ = blk
    h = conv_u8(x, params[f"{name}_expand"]) if mid != cin else x
    p = params[f"{name}_dw"]
    h = ops.requant(depthwise_acc(h, p["wei"], stride), p["bia"],
                    p["conv0_scales"], True, "u8")
    p = params[f"{name}_project"]
    acc = ops.conv_acc(h, p["wei"])
    if residual(blk):
        return requant_sum_s8(acc, p["bia"], p["conv0_scales"], x)
    return requant_s8(acc, p["bia"], p["conv0_scales"])


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (n, classes) float32 of u8 images x (n, hw, hw, in_ch)."""
    y = conv_u8(x.to(torch.float32), params["stem"], 2)
    for blk in blocks({"hw": x.shape[1]}):
        y = block(params, blk, y)
    y = conv_u8(y, params["last"])
    return ops.head(ops.global_avgpool_u8(y), params["head"])
