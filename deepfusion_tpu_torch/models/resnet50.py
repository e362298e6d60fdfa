"""ResNet-50 v1.5: the public INT8 CNN benchmark, on the dense fused path.

He et al., "Deep Residual Learning for Image Recognition" (arXiv:1512.03385,
Table 1, the 50-layer column), with v1.5's strides (torchvision's
``resnet50``, MLPerf Inference's ``resnet50-v1.5``): a 7x7/s2 stem, a
3x3/s2/p1 max pool, four stages of 3, 4, 6 and 3 bottleneck blocks of
widths w, 2w, 4w and 8w, a global average pool and the classifier. A block
is a 1x1 reduce, a 3x3 (stride 2 in the first block of stages 2-4) and a
1x1 expand to 4x the width that adds the shortcut and applies ReLU.

On the port's ops, one ``ConvOp`` per layer:

* ``stem``: 7x7/s2/p3, u8 with ReLU (run as a 7x1 conv over the input's
  seven column taps folded into 32 channels, ``ops/conv.py:
  unfold_cols``), then ``pool(..., "max", (3, 3), (2, 2), (1, 1))``
  in floor mode: the values are u8 after a ReLU, so zero padding is the
  max's identity;
* ``s{i}b{j}_reduce``: the 1x1 reduce, u8 with ReLU;
* ``s{i}b1_proj``: each stage's projection shortcut, a 1x1 at the stage's
  stride requantized to s8 with no ReLU;
* ``s{i}b{j}_fused``: the block's 3x3 and its expand in one launch of the
  fused conv (``conv_fused_kernel<true, u8>``): the 3x3's u8 intermediate
  stays on chip, and the shortcut (the block input's u8, or the
  projection's s8) joins the expand's epilogue as the sum post-op with
  scale ``SUM_SCALE``: ``round(x) + round(sum)``, ReLU, saturate;
* the global ``avg_exc`` pool and the f32 ``head``.

Each layer of an eager forward is a ``model.layer`` span (attrs ``name``
and ``kind``: stem, maxpool, reduce, proj, fused, avgpool, head) while a
``torch.profiler`` records (``utils/profiler.py``), so a trace gives each
layer kind's kernels; a graph replay runs none of them. ``jit()`` is the
forward as a compiled callable (``models/graphed.py``); there is no packed
path.

``random_params`` draws the models' ``_mkconv`` calibration from a numpy
generator; ``from_numpy_params`` takes any weights by layer name.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..ops.conv import ConvOp
from ..ops.pool import pool
from ..utils.logger import check
from ..utils.profiler import span
from .fusionnet import _conv_config, _mkconv
from .graphed import GraphedForward

BLOCKS = (3, 4, 6, 3)    # bottleneck blocks per stage
EXPANSION = 4            # a block's output over its width
SUM_SCALE = 1.0          # the shortcut's scale in the expand's epilogue
# The rms the weights are calibrated for (``_mkconv``'s in_std): u8 images
# uniform over 0..255, the stem's pooled output, and the residual stream
# after one block; the stream's rms grows about as the square root of the
# blocks summed into it since the last projection.
IMAGE_RMS, POOL_RMS, BLOCK_RMS = 147.0, 55.0, 50.0


@dataclasses.dataclass
class ResNet50Config:
    batch: int = 8
    hw: int = 224           # divisible by 32 (stem, pool, three strides)
    in_ch: int = 3
    width: int = 64         # stage 1's bottleneck width; stages double it
    num_classes: int = 1000
    seed: int = 0


class Layer(NamedTuple):
    """One conv of the network: its name and kind, kernel, channels (and
    the fused expand's), stride, input resolution, destination, ReLU and
    the input rms its weights are calibrated for."""
    name: str
    kind: str
    k: int
    ic: int
    oc: int
    oc1x1: Optional[int]
    stride: int
    in_hw: int
    dst: str
    relu: bool
    in_std: float


def stream_rms(stage: int, block: int) -> float:
    """The rms of the residual stream a block reads: the stem's pooled
    output, or the stream after the blocks summed into it since the last
    projection (all of the previous stage's, in a stage's first block)."""
    if (stage, block) == (1, 1):
        return POOL_RMS
    summed = BLOCKS[stage - 2] if block == 1 else block - 1
    return BLOCK_RMS * summed ** 0.5


def layer_plan(cfg: ResNet50Config) -> list:
    """The 38 convs in the order the forward runs them and
    ``random_params`` draws them."""
    w = cfg.width
    out = [Layer("stem", "stem", 7, cfg.in_ch, w, None, 2, cfg.hw, "u8",
                 True, IMAGE_RMS)]
    cin, res = w, cfg.hw // 4
    for s, n_blocks in enumerate(BLOCKS, start=1):
        width = w << (s - 1)
        cout = EXPANSION * width
        for b in range(1, n_blocks + 1):
            stride = 2 if s > 1 and b == 1 else 1
            std = stream_rms(s, b)
            out.append(Layer(f"s{s}b{b}_reduce", "reduce", 1, cin, width,
                             None, 1, res, "u8", True, std))
            if b == 1:
                out.append(Layer(f"s{s}b1_proj", "proj", 1, cin, cout, None,
                                 stride, res, "s8", False, std))
            out.append(Layer(f"s{s}b{b}_fused", "fused", 3, width, width,
                             cout, stride, res, "u8", True, 30.0))
            cin, res = cout, res // stride
    out.append(Layer("head", "head", 1, cin, cfg.num_classes, None, 1, 1,
                     "f32", False, 30.0))
    return out


class ResNet50(nn.Module):
    """INT8 ResNet-50 v1.5: stem -> max pool -> 16 bottleneck blocks ->
    global average pool -> f32 head.

    The forward takes any batch size; ``cfg.batch`` is the batch that
    ``input_shape`` and ``example_input`` use."""

    def __init__(self, cfg: ResNet50Config = ResNet50Config(), device=None,
                 params: Optional[dict] = None):
        super().__init__()
        check(cfg.hw % 32 == 0, "hw must be divisible by 32")
        self.cfg = cfg
        if params is None:
            params = self.random_params(cfg)
        self.convs = nn.ModuleDict()
        # per block its layers' names: reduce, projection (or None), fused
        self._blocks = []
        for layer in layer_plan(cfg):
            p = params[layer.name]
            if layer.kind == "reduce":
                reduce, proj = layer.name, None
            elif layer.kind == "proj":
                proj = layer.name
            elif layer.kind == "fused":
                # the shortcut: the projection's s8, or the block input's u8
                p = dict(p, sum_dt="u8" if proj is None else "s8",
                         sum_scale=SUM_SCALE)
                self._blocks.append((reduce, proj, layer.name))
            self.convs[layer.name] = ConvOp(
                _conv_config(cfg.batch, layer.in_hw, p, layer.stride),
                p["wei"], p.get("bia"), p.get("wei1"), p.get("bia1"),
                device=device)
        self._in_shape = (cfg.batch, cfg.hw, cfg.hw, cfg.in_ch)

    @staticmethod
    def random_params(cfg: ResNet50Config) -> dict:
        """``_mkconv``'s draw for `cfg.seed`, layer by layer in
        ``layer_plan``'s order."""
        rng = np.random.default_rng(cfg.seed)
        return {l.name: _mkconv(rng, l.k, l.ic, l.oc, l.dst, oc1x1=l.oc1x1,
                                relu=l.relu, in_std=l.in_std)
                for l in layer_plan(cfg)}

    @classmethod
    def from_numpy_params(cls, cfg: ResNet50Config, params: dict,
                          device=None) -> "ResNet50":
        """Build from parameters given as numpy arrays, one dict per layer
        name of ``layer_plan`` (``wei``, ``bia``, ``conv0_scales``,
        ``conv0_relu``, ``dst_dt``; a fused layer also ``wei1``, ``bia1``,
        ``conv1_scales``, ``conv1_relu``). The model adds each fused
        layer's sum operand: u8 for an identity shortcut, s8 for a
        projection, at ``SUM_SCALE``."""
        return cls(cfg, device=device, params=params)

    @property
    def device(self) -> torch.device:
        return self.convs["head"].device

    @property
    def input_shape(self):
        return self._in_shape

    def example_input(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(50)
        return rng.integers(0, 256, self._in_shape, dtype=np.uint8)

    def forward(self, x_u8) -> torch.Tensor:
        c = self.convs
        x = torch.as_tensor(x_u8, device=self.device)
        with span("model.layer", name="stem", kind="stem"):
            x = c["stem"](x)
        with span("model.layer", name="maxpool", kind="maxpool"):
            x = pool(x, "max", (3, 3), (2, 2), (1, 1), ceil_mode=False)
        for reduce, proj, fused in self._blocks:
            with span("model.layer", name=reduce, kind="reduce"):
                r = c[reduce](x)
            if proj is not None:
                with span("model.layer", name=proj, kind="proj"):
                    x = c[proj](x)
            with span("model.layer", name=fused, kind="fused"):
                x = c[fused](r, sum_src=x)
        with span("model.layer", name="avgpool", kind="avgpool"):
            h, w = x.shape[1], x.shape[2]
            x = pool(x, "avg_exc", (h, w), (h, w), (0, 0))
        with span("model.layer", name="head", kind="head"):
            logits = c["head"](x)                   # (n, 1, 1, classes)
        return logits.reshape(logits.shape[0], -1)

    def jit(self) -> GraphedForward:
        """The forward as a compiled callable: on the card one CUDA graph
        per input shape, replayed per call (``models/graphed.py``); on the
        CPU the forward itself."""
        return GraphedForward(self.forward)
