"""VGGFusion, plain: three blocks of conv3x3+ReLU -> conv3x3+ReLU -> 2x2
max pool (widths w, 2w, 4w), a global average pool and an f32 head (the
layers of the repository's ``deepfusion_tpu/models/vggfusion.py``)."""
from __future__ import annotations

import torch

from . import ops

N_BLOCKS = 3


def layers(cfg: dict) -> list:
    """The layers of ``cfg`` (hw, in_ch, width, num_classes) in the models'
    order, as ``fusionnet.layers``; each block's second conv carries its
    2x2 pool (``pool`` 2)."""
    chans = [cfg["in_ch"]] + [cfg["width"] << b for b in range(N_BLOCKS)]
    out = []
    for b in range(N_BLOCKS):
        h = cfg["hw"] >> b
        out.append(dict(name=f"block{b + 1}_conv1", k=3, ic=chans[b],
                        oc=chans[b + 1], oc1x1=None, hw=h, pool=1, dst="u8",
                        relu=True, in_std=74.0 if b == 0 else 30.0))
        out.append(dict(name=f"block{b + 1}_conv2", k=3, ic=chans[b + 1],
                        oc=chans[b + 1], oc1x1=None, hw=h, pool=2, dst="u8",
                        relu=True, in_std=30.0))
    out.append(dict(name="head", k=1, ic=chans[-1], oc=cfg["num_classes"],
                    oc1x1=None, hw=1, pool=1, dst="f32", relu=False,
                    in_std=30.0))
    return out


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits (n, classes) float32 of u8 images x (n, hw, hw, in_ch)."""
    y = x.to(torch.float32)
    for b in range(1, N_BLOCKS + 1):
        y = ops.conv(y, params[f"block{b}_conv1"])
        y = ops.maxpool2(ops.conv(y, params[f"block{b}_conv2"]))
    return ops.head(ops.global_avgpool_u8(y), params["head"])
