"""GoogLeNet (Inception-v1), plain: a 7x7/s2 stem, a 3x3/s2 max pool, a
1x1 reduce and a 3x3 to 192 channels, a 3x3/s2 max pool, nine Inception
modules (3a-3b at 28x28, a 3x3/s2 max pool, 4a-4e at 14x14, a 3x3/s2 max
pool, 5a-5b at 7x7), a 7x7 global average pool and the classifier (Szegedy
et al., "Going Deeper with Convolutions", arXiv:1409.4842, Table 1; Caffe's
``bvlc_googlenet``). A module feeds one input to four branches, a 1x1; a
1x1 reduce then a 3x3; a 1x1 reduce then a 5x5; a 3x3/s1/p1 max pool then
a 1x1 pool projection, and joins their outputs along the channels in that
order. The four 3x3/s2 max pools have no padding and take the ceil-mode
output size (Caffe's rule): 112 -> 56 -> 28 -> 14 -> 7.

Departures from the published model, all of them the int8 engine's or
inference's:

* the two local response normalizations (after the stem's pool and after
  the 3x3 to 192) are left out: LRN is not an integer op, and the
  batch-norm era's implementations, torchvision's ``googlenet`` among
  them, drop it;
* batch norm is folded into each conv's bias and per-channel scale, and
  the input is raw u8 NHWC images, with no mean and std step;
* the two auxiliary classifiers (after 4a and 4d) are left out: they serve
  training only;
* dropout is the identity at inference;
* the forward ends at the logits, with no softmax;
* branch 3 is the paper's 5x5 (torchvision's ``googlenet`` runs a 3x3
  there, a known discrepancy it keeps for its weights' sake);
* the global average pool rounds to u8 (half to even) before the head,
  and the fully connected head is a 1x1 conv with an f32 output;
* every conv requantizes to u8 with ReLU, and the concats join u8 values,
  so they need no ReLU of their own;
* the weights are random and seeded (``portbench/weights.py``).

Every accumulator is exact in float32 (the largest, 5b's 3x3 over 192
channels, reaches 16 x 255 x 9 x 192 = 7,050,240 < 2**24), so the convs
are ``ops.conv_acc``'s. The max pools run on float32 that holds u8 values
after a ReLU, so zero padding is the max's identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ops

# Table 1's modules: name, #1x1, #3x3 reduce, #3x3, #5x5 reduce, #5x5,
# pool proj; a 3x3/s2 max pool before 4a and before 5a
MODULES = (("3a", 64, 96, 128, 16, 32, 32),
           ("3b", 128, 128, 192, 32, 96, 64),
           ("4a", 192, 96, 208, 16, 48, 64),
           ("4b", 160, 112, 224, 24, 64, 64),
           ("4c", 128, 128, 256, 24, 64, 64),
           ("4d", 112, 144, 288, 32, 64, 64),
           ("4e", 256, 160, 320, 32, 128, 128),
           ("5a", 256, 160, 320, 32, 128, 128),
           ("5b", 384, 192, 384, 48, 128, 128))
POOLED_BEFORE = ("4a", "5a")
# The rms the weights are calibrated for (``weights.draw``'s in_std), measured
# layer by layer on the calibrated network at 224x224 (two seeds): u8
# images uniform over 0..255; the stem's pooled output; a conv's u8 output
# after ReLU (and so a module's concat); a 3x3 max pool of a module's
# input that is such an output; the branch pool of a module's input that
# is itself pooled (a max of maxes); the global average of the last
# module.
IMAGE_RMS, STEM_POOL_RMS, CONV_RMS, POOL_RMS, POOL_POOL_RMS, AVG_RMS = \
    147.0, 57.0, 34.0, 41.0, 47.0, 29.0


def _layer(name, k, ic, oc, hw, *, stride=1, pool=1, dst="u8", relu=True,
           std=CONV_RMS):
    return dict(name=name, k=k, ic=ic, oc=oc, oc1x1=None, hw=hw, pool=pool,
                stride=stride, dst=dst, relu=relu, in_std=std)


def layers(cfg: dict) -> list:
    """The 58 layers of ``cfg`` (hw, in_ch, num_classes) in the order the
    weights are drawn and the forward runs them: name, kernel, input and
    output channels, the output resolution ``hw`` (the stem's and the 3x3
    to 192's ``pool`` 2 is the max pool after each), the stride,
    destination, ReLU and the input rms the weights are calibrated for.
    Each module's pool projection, its last layer, also carries ``concat``:
    the module's output lanes, which its concat writes at ``hw``."""
    hw = -(-cfg["hw"] // 2)                  # the stem's output
    out = [_layer("stem", 7, cfg["in_ch"], 64, hw, stride=2, pool=2,
                  std=IMAGE_RMS)]
    hw = pooled(hw)
    out.append(_layer("conv2_reduce", 1, 64, 64, hw, std=STEM_POOL_RMS))
    out.append(_layer("conv2", 3, 64, 192, hw, pool=2))
    hw, cin, pooled_in = pooled(hw), 192, True
    for m, n1, r3, n3, r5, n5, pp in MODULES:
        if m in POOLED_BEFORE:
            hw, pooled_in = pooled(hw), True
        std = POOL_RMS if pooled_in else CONV_RMS
        out += [_layer(f"{m}_1x1", 1, cin, n1, hw, std=std),
                _layer(f"{m}_3x3_reduce", 1, cin, r3, hw, std=std),
                _layer(f"{m}_3x3", 3, r3, n3, hw),
                _layer(f"{m}_5x5_reduce", 1, cin, r5, hw, std=std),
                _layer(f"{m}_5x5", 5, r5, n5, hw),
                dict(_layer(f"{m}_pool_proj", 1, cin, pp, hw,
                            std=POOL_POOL_RMS if pooled_in else POOL_RMS),
                     concat=n1 + n3 + n5 + pp)]
        cin, pooled_in = n1 + n3 + n5 + pp, False
    out.append(_layer("head", 1, cin, cfg["num_classes"], 1, dst="f32",
                      relu=False, std=AVG_RMS))
    return out


def pooled(hw: int) -> int:
    """The output size of a 3x3/s2 max pool with no padding, ceil mode."""
    return -(-(hw - 3) // 2) + 1


def maxpool3s2_ceil(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 2, no padding, ceil mode: a last window that
    runs past the image takes only its taps inside (zero padding at the
    bottom and right, the max's identity for u8 values)."""
    n, h, w, c = x.shape
    oh, ow = pooled(h), pooled(w)
    xp = F.pad(x, (0, 0, 0, 2 * ow + 1 - w, 0, 2 * oh + 1 - h))
    out = None
    for ki in range(3):
        for kj in range(3):
            tap = xp[:, ki:ki + 2 * (oh - 1) + 1:2,
                     kj:kj + 2 * (ow - 1) + 1:2, :]
            out = tap if out is None else torch.maximum(out, tap)
    return out


def maxpool3s1(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, stride 1, padding 1: the branch pool, same size out."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for ki in range(3):
        for kj in range(3):
            tap = xp[:, ki:ki + h, kj:kj + w, :]
            out = tap if out is None else torch.maximum(out, tap)
    return out


def inception(params: dict, m: str, x: torch.Tensor) -> torch.Tensor:
    """One module: its four branches joined along the channels."""
    b1 = ops.conv(x, params[f"{m}_1x1"])
    b2 = ops.conv(ops.conv(x, params[f"{m}_3x3_reduce"]), params[f"{m}_3x3"])
    b3 = ops.conv(ops.conv(x, params[f"{m}_5x5_reduce"]), params[f"{m}_5x5"])
    b4 = ops.conv(maxpool3s1(x), params[f"{m}_pool_proj"])
    return torch.cat([b1, b2, b3, b4], dim=-1)


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (n, classes) float32 of u8 images x (n, hw, hw, in_ch)."""
    y = maxpool3s2_ceil(ops.conv(x.to(torch.float32), params["stem"], 2))
    y = ops.conv(ops.conv(y, params["conv2_reduce"]), params["conv2"])
    y = maxpool3s2_ceil(y)
    for m, *_ in MODULES:
        if m in POOLED_BEFORE:
            y = maxpool3s2_ceil(y)
        y = inception(params, m, y)
    return ops.head(ops.global_avgpool_u8(y), params["head"])
