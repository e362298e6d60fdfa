"""FusionNet, plain: stem -> fused 3x3+1x1 block -> 1x1 branch -> concat
-> 1x1 residual conv -> saturating sum + ReLU -> 2x2 max pool -> fused
block -> global average pool -> f32 head (the layers of the repository's
``deepfusion_tpu/models/fusionnet.py``)."""
from __future__ import annotations

import torch

from . import ops


def layers(cfg: dict) -> list:
    """The layers of ``cfg`` (hw, in_ch, width, num_classes), in the
    models' order: name, kernel, input and output channels, the fused 1x1's
    channels, input size, output pool, destination, ReLU and the input
    spread the weights are calibrated for."""
    hw, c, w = cfg["hw"], cfg["in_ch"], cfg["width"]

    def layer(name, k, ic, oc, h, oc1=None, dst="u8", relu=True,
              in_std=30.0):
        return dict(name=name, k=k, ic=ic, oc=oc, oc1x1=oc1, hw=h, pool=1,
                    dst=dst, relu=relu, in_std=in_std)
    return [layer("stem", 3, c, w, hw, in_std=74.0),
            layer("block1", 3, w, w, hw, oc1=w),
            layer("branch", 1, w, w, hw),
            layer("res", 1, 2 * w, 2 * w, hw),
            layer("block2", 3, 2 * w, 2 * w, hw // 2, oc1=w),
            layer("head", 1, w, cfg["num_classes"], 1, dst="f32",
                  relu=False)]


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (n, classes) float32 of u8 images x (n, hw, hw, in_ch)."""
    x = x.to(torch.float32)
    x = ops.conv(x, params["stem"])
    a = ops.conv(x, params["block1"])
    b = ops.conv(x, params["branch"])
    y = torch.cat([a, b], dim=-1)          # ReLU of u8 is the identity
    r = ops.conv(y, params["res"])
    y = ops.maxpool2(ops.sum_relu_u8(y, r))
    y = ops.conv(y, params["block2"])
    return ops.head(ops.global_avgpool_u8(y), params["head"])
