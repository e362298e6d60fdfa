"""MobileNetV2 (width 1.0) on the dense path: 17 inverted residual blocks.

Sandler et al., "MobileNetV2: Inverted Residuals and Linear Bottlenecks"
(arXiv:1801.04381, Table 2; torchvision's ``mobilenet_v2``): a 3x3/s2 conv
to 32 channels, seven groups of inverted residual blocks (t, c, n, s) =
(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
(6, 160, 3, 2), (6, 320, 1, 1), a 1x1 conv to 1,280 channels, a 7x7
global average pool and the classifier. A block is a 1x1 expand to t times
its input's channels (none where t is 1), a 3x3 depthwise conv at the
block's stride and a linear 1x1 projection; where the stride is 1 and the
channels are kept (10 of the 17), the block input is added to the
projection, with no activation after the sum.

On the port's ops, one op per layer:

* ``stem``: ``ConvOp`` 3x3/s2/p1 over 3 channels, u8 with ReLU (run over
  the input's three column taps folded into 32 channels, ``ops/conv.py:
  unfold_cols``);
* ``b{i}_expand`` (blocks 2-17): ``ConvOp`` 1x1 over the s8 stream (an s8
  source, ``conv_fused_s8src_kernel`` on the card), u8 with ReLU;
* ``b{i}_dw``: ``DepthwiseOp`` (``ops/depthwise.py``, ``depthwise_kernel``),
  u8 to u8 with ReLU;
* ``b{i}_project``: ``ConvOp`` 1x1, u8 to s8 with no ReLU; in a block with
  a residual the block input is its s8 sum operand: ``round(x) +
  round(sum * SUM_SCALE)``, saturated to s8;
* ``last``: ``ConvOp`` 1x1 320 -> 1,280 over the s8 stream, u8 with ReLU;
* the global ``avg_exc`` pool (K3) and the f32 ``head``.

Departures from the published model, as in ``portbench/reference/
mobilenetv2.py`` and as integer-only MobileNetV2 runs it (Jacob et al.,
arXiv:1712.05877): ReLU6 is the u8 saturation (the output scale of a conv
followed by ReLU6 maps 6.0 to 255, so the clip at 6 is the clamp at 255);
the linear bottlenecks are s8 and the residual sum saturates to s8; batch
norm is folded into each conv's bias and scale; the input is raw u8 NHWC
images with no mean and std step; the head is an f32 1x1 over the average
pool rounded to u8; dropout is the identity; the weights are seeded and
random.

Each layer of an eager forward is a ``model.layer`` span (attrs ``name``,
``kind``: stem, expand, depthwise, project, project_sum, last, avgpool,
head; ``stride`` and ``channels``: the layer's stride and output channels)
while a ``torch.profiler`` records (``utils/profiler.py``); a graph replay
runs none of them. ``jit()`` is the forward as a compiled callable
(``models/graphed.py``); there is no packed path.

``random_params`` draws the models' ``_mkconv`` calibration from a numpy
generator, each layer for its input's rms; ``from_numpy_params`` takes any
weights by layer name.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..ops.conv import ConvOp
from ..ops.depthwise import DepthwiseConfig, DepthwiseOp
from ..ops.pool import pool
from ..utils.mathutil import conv_output_size
from ..utils.profiler import span
from .fusionnet import _conv_config, _mkconv
from .graphed import GraphedForward

# Table 2's bottleneck groups: expansion t, output channels c, blocks n,
# the first block's stride s
GROUPS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
STEM_CH, LAST_CH = 32, 1280
SUM_SCALE = 1.0          # the block input's scale in the projection's sum
# The rms the weights are calibrated for (``_mkconv``'s in_std), measured
# layer by layer on the calibrated network at 224x224 (two seeds): u8
# images uniform over 0..255; a dense conv's u8 output after ReLU (the
# stem's and each expand's: a depthwise input); a depthwise output (a
# projection's input); the s8 stream after m projections summed into it
# since the last one without a residual (STREAM_RMS[m - 1]: about the
# square root of m, saturation aside); the global average of the last 1x1.
IMAGE_RMS, CONV_RMS, DW_RMS, AVG_RMS = 147.0, 34.5, 33.0, 29.0
STREAM_RMS = (49.0, 66.0, 75.0, 79.0)


@dataclasses.dataclass
class MobileNetV2Config:
    batch: int = 8
    hw: int = 224
    in_ch: int = 3
    num_classes: int = 1000
    seed: int = 0


class Layer(NamedTuple):
    """One layer of the network: its name and kind, kernel, channels (a
    depthwise layer's ``ic`` 1), stride, input resolution, source and
    destination, ReLU and the input rms its weights are calibrated for."""
    name: str
    kind: str
    k: int
    ic: int
    oc: int
    stride: int
    in_hw: int
    src: str
    dst: str
    relu: bool
    in_std: float


def layer_plan(cfg: MobileNetV2Config) -> list:
    """The 53 layers (52 convs and the head) in the order the forward runs
    them and ``random_params`` draws them."""
    out = [Layer("stem", "stem", 3, cfg.in_ch, STEM_CH, 2, cfg.hw, "u8",
                 "u8", True, IMAGE_RMS)]
    cin, hw, i, prev = STEM_CH, conv_output_size(cfg.hw, 3, 2, 1), 0, 0
    for t, c, n, s in GROUPS:
        for j in range(n):
            i += 1
            stride = s if j == 0 else 1
            mid = cin * t
            # the projections summed into the stream this block reads
            summed = j if j else prev
            if t != 1:
                out.append(Layer(f"b{i}_expand", "expand", 1, cin, mid, 1,
                                 hw, "s8", "u8", True,
                                 STREAM_RMS[summed - 1]))
            out.append(Layer(f"b{i}_dw", "depthwise", 3, 1, mid, stride, hw,
                             "u8", "u8", True, CONV_RMS))
            kind = "project_sum" if stride == 1 and cin == c else "project"
            hw = conv_output_size(hw, 3, stride, 1)
            out.append(Layer(f"b{i}_project", kind, 1, mid, c, 1, hw, "u8",
                             "s8", False, DW_RMS))
            cin = c
        prev = n
    out.append(Layer("last", "last", 1, cin, LAST_CH, 1, hw, "s8", "u8",
                     True, STREAM_RMS[prev - 1]))
    out.append(Layer("head", "head", 1, LAST_CH, cfg.num_classes, 1, 1,
                     "u8", "f32", False, AVG_RMS))
    return out


class MobileNetV2(nn.Module):
    """INT8 MobileNetV2: stem -> 17 inverted residual blocks -> 1x1 to
    1,280 -> global average pool -> f32 head.

    The forward takes any batch size; ``cfg.batch`` is the batch that
    ``input_shape`` and ``example_input`` use."""

    def __init__(self, cfg: MobileNetV2Config = MobileNetV2Config(),
                 device=None, params: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = self.random_params(cfg)
        self.ops = nn.ModuleDict()
        self.plan = layer_plan(cfg)
        for layer in self.plan:
            p = params[layer.name]
            if layer.kind == "depthwise":
                dcfg = DepthwiseConfig.make(
                    (cfg.batch, layer.in_hw, layer.in_hw, layer.oc),
                    np.shape(p["wei"]), layer.stride, p["conv0_scales"])
                self.ops[layer.name] = DepthwiseOp(dcfg, p["wei"], p["bia"],
                                                   device)
                continue
            p = dict(p, src_dt=layer.src)
            if layer.kind == "project_sum":
                p.update(sum_dt="s8", sum_scale=SUM_SCALE)
            self.ops[layer.name] = ConvOp(
                _conv_config(cfg.batch, layer.in_hw, p, layer.stride),
                p["wei"], p.get("bia"), device=device)
        self._in_shape = (cfg.batch, cfg.hw, cfg.hw, cfg.in_ch)

    @staticmethod
    def random_params(cfg: MobileNetV2Config) -> dict:
        """``_mkconv``'s draw for `cfg.seed`, layer by layer in
        ``layer_plan``'s order (a depthwise layer's weights (c, 1, 3,
        3))."""
        rng = np.random.default_rng(cfg.seed)
        return {l.name: _mkconv(rng, l.k, l.ic, l.oc, l.dst, relu=l.relu,
                                in_std=l.in_std)
                for l in layer_plan(cfg)}

    @classmethod
    def from_numpy_params(cls, cfg: MobileNetV2Config, params: dict,
                          device=None) -> "MobileNetV2":
        """Build from parameters given as numpy arrays, one dict per layer
        name of ``layer_plan`` (``wei``, ``bia``, ``conv0_scales``,
        ``conv0_relu``, ``dst_dt``). The model sets each layer's source
        dtype and each residual projection's s8 sum operand at
        ``SUM_SCALE``."""
        return cls(cfg, device=device, params=params)

    @property
    def device(self) -> torch.device:
        return self.ops["head"].device

    @property
    def input_shape(self):
        return self._in_shape

    def example_input(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(1801)
        return rng.integers(0, 256, self._in_shape, dtype=np.uint8)

    def _layer(self, layer: Layer, x: torch.Tensor, sum_src=None):
        with span("model.layer", name=layer.name, kind=layer.kind,
                  stride=layer.stride, channels=layer.oc):
            op = self.ops[layer.name]
            return op(x) if sum_src is None else op(x, sum_src=sum_src)

    def forward(self, x_u8) -> torch.Tensor:
        x = torch.as_tensor(x_u8, device=self.device)
        block_in = None
        for layer in self.plan[:-1]:
            if layer.kind in ("expand", "depthwise") and block_in is None:
                block_in = x              # a block starts: its input
            if layer.kind == "project_sum":
                x = self._layer(layer, x, sum_src=block_in)
            else:
                x = self._layer(layer, x)
            if layer.kind.startswith("project"):
                block_in = None
        with span("model.layer", name="avgpool", kind="avgpool", stride=1,
                  channels=x.shape[-1]):
            h, w = x.shape[1], x.shape[2]
            x = pool(x, "avg_exc", (h, w), (h, w), (0, 0))
        logits = self._layer(self.plan[-1], x)     # (n, 1, 1, classes)
        return logits.reshape(logits.shape[0], -1)

    def jit(self) -> GraphedForward:
        """The forward as a compiled callable: on the card one CUDA graph
        per input shape, replayed per call (``models/graphed.py``); on the
        CPU the forward itself."""
        return GraphedForward(self.forward)
